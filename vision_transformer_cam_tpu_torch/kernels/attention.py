"""Fused masked multi-head attention with the CAM statistics.

``masked_attention_fused`` is the port of the TPU kernel's entry point
(vision_transformer_cam_tpu/kernels/attention.py: masked_attention_fused),
with its int8 serving options: ``int8_io`` (int8 qkv with per-head or
per-tensor scales, int8 output) and ``int8_out`` (float qkv, int8 output).
On a CUDA tensor it launches the hand-written Hopper kernel
in ``csrc/masked_attention.cu`` (bf16 and int8 qkv its tensor-core design,
float32 its FMA design: ``fwd_design``); on a CPU tensor it runs
``masked_attention_fused_ref``, the plain PyTorch version of the same math,
which the CPU tests hold against the JAX kernel.  There is no fallback from
one to the other.

``masked_attention_bwd`` is the port of the TPU backward kernel (same file:
masked_attention_bwd): d_qkv from (qkv, bg, dO) with the probabilities
recomputed on chip, ``csrc/masked_attention_bwd.cu`` on a CUDA tensor and
``masked_attention_bwd_ref`` on a CPU tensor.  ``fused_attention_diff`` joins
the two into a differentiable attention (the TPU package's custom_vjp of the
same name) for training.

``attention_block_fused`` is the port of the TPU kernel of the same name:
the whole attention sub-block, ``tokens + proj(attention(qkv(xn)))`` with the
cls row and the rollout update, in one launch; neither the qkv tensor nor the
attention output reaches device memory.  ``csrc/attention_block.cu`` (the
cluster design: bf16 its tensor-core attention core, float32 its FMA core)
or ``csrc/attention_block_streamed.cuh`` (the streamed design, past the
cluster design's shapes and at head width 80) on a CUDA tensor, chosen by
``block_design``; ``attention_block_fused_plain`` on a CPU tensor.

``masked_attention_seq_local`` is the port of the TPU sequence-parallel
kernel (same file: _masked_attention_seq_local): a rank's local query rows
against the gathered K | V rows of a token axis padded to the group size,
with the padded key columns killed, ``csrc/masked_attention_seq.cu`` on a
CUDA tensor and ``masked_attention_seq_local_ref`` on a CPU tensor.
``masked_attention_seq`` is the TPU package's wrapper of the same name
written out for ``torch.distributed``: all-gather of K | V and bg over the
sequence group, the local kernel call, the cls row from sequence-rank 0.

``masked_attention`` is the port of the TPU package's first attention kernel
(same file: masked_attention), on split q, k, v [B, H, N, dh] with the
reference's symmetric pair mask and the row-max softmax,
``csrc/masked_attention_v1.cuh`` (its C entry points in
``masked_attention_v1.cu``) on a CUDA tensor (bf16 its tensor-core design,
float32 its FMA design: ``v1_design``) and ``masked_attention_ref`` on a CPU
tensor.  No model path runs it; ``scripts.microbench`` drives it.

``launches``, ``bwd_launches``, ``block_launches``, ``seq_launches`` and
``v1_launches`` count the CUDA kernel launches made through the forward, the
backward, the block, the sequence-parallel and the split-tensor wrapper, so a
run can show that its main path went through the kernels;
``width_launches``, ``bwd_width_launches``, ``seq_width_launches`` and
``v1_width_launches`` split the forward's, the backward's, the
sequence-parallel and the split-tensor kernel's counts by head width,
``block_streamed_launches`` the block wrapper's calls that ran the streamed
design, by head width.
"""

from __future__ import annotations

import torch

launches = 0
bwd_launches = 0
block_launches = 0
seq_launches = 0
v1_launches = 0

# mode codes of the C entry point
_PLAIN, _HEADMEAN, _ROLLOUT = 0, 1, 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# scales-vector kinds and flags of the C entry point
_NO_SCALES, _OUT_ONLY, _PER_TENSOR, _PER_HEAD = 0, 1, 2, 3
_OUT_I8, _CLS_BF16, _HM_BF16 = 1, 2, 4
# The head widths kernel 1 (masked_attention_fused) and the backward
# (masked_attention_bwd) are compiled for: 64 (ViT-S/B/L), 80 (ViT-H/14), 16
# (the JAX quickstart's tiny ViT) and 32 and 40 (the JAX kernel tests' fuzz
# widths), each its own set of instances (csrc/masked_attention.cu and
# masked_attention_w16.cu, _w32, _w40, _w80; csrc/masked_attention_bwd.cu and
# masked_attention_bwd_w16.cu, ...), and the sequence-parallel kernel
# (masked_attention_seq) the same widths (csrc/masked_attention_seq.cu and
# masked_attention_seq_w16.cu, ...), the split-tensor kernel
# (masked_attention) the same widths (csrc/masked_attention_v1.cu and
# masked_attention_v1_w16.cu, ...), and the block kernel's streamed design
# the same widths (BLOCK_HEAD_DIMS: csrc/attention_block_streamed.cu and
# attention_block_streamed_w16.cu, ...).  The other CUDA kernels take
# HEAD_DIM only.
FWD_HEAD_DIMS = (16, 32, 40, 64, 80)
BWD_HEAD_DIMS = (16, 32, 40, 64, 80)
SEQ_HEAD_DIMS = FWD_HEAD_DIMS
V1_HEAD_DIMS = FWD_HEAD_DIMS
HEAD_DIM = 64
# kernel 1's launches, the backward's calls, the sequence-parallel and the
# split-tensor kernel's launches by head width (each also counts in
# ``launches`` / ``bwd_launches`` / ``seq_launches`` / ``v1_launches``)
width_launches = {dh: 0 for dh in FWD_HEAD_DIMS}
bwd_width_launches = {dh: 0 for dh in BWD_HEAD_DIMS}
seq_width_launches = {dh: 0 for dh in SEQ_HEAD_DIMS}
v1_width_launches = {dh: 0 for dh in V1_HEAD_DIMS}
# The CUDA backward has three designs.  bf16 runs the tensor-core design: a
# dQ kernel per 64 query rows and a dK / dV kernel per 64 keys, products on
# mma.sync, a [B, H, N, 3] float32 scratch of row statistics between them;
# its shared memory grows by one float a key only.  float32 keeps the FMA
# designs, whose [rows, N] float32 tiles set the limits, per head width dh
# (floats of the 227 KB a block may use on sm_90):
#   one block per (image, head), dK and dV [N, dh] beside two [32, N] tiles:
#     (2 dh + 64) * ceil4(N) + N + 64 dh + 64 (dh + 4) + 32 floats of the
#     58112, N <= BWD_ONE_BLOCK_MAX_N:
#       16: 96 ceil4(N) + N + 2336 -> 572;
#       32: 128 ceil4(N) + N + 4384 -> 416;
#       40: 144 ceil4(N) + N + 5408 -> 360;
#       64: 192 ceil4(N) + N + 8480 -> 256;
#       80: 224 ceil4(N) + N + 10528 -> 208;
#   past it two kernels, one per query tile of 32 rows (dQ and the rows'
#     softmax statistics; N <= 856, 824, 808, 760 and 732 at 16, 32, 40, 64
#     and 80), or of 16 past that: 32 * ceil4(N) + N + 32 dh + 64 (dh + 4) +
#     16 floats, N <= BWD_MAX_N:
#       16: 32 ceil4(N) + N + 1808 -> 1704;  32: ... + 3344 -> 1656;
#       40: ... + 4112 -> 1636;  64: ... + 6416 -> 1564;
#       80: ... + 7952 -> 1520;
#     and one per 64 keys (dK, dV) whatever N is.
# Both dtypes take the same N <= BWD_MAX_N, so that a model trains the same
# shapes in float32 and in bf16.
BWD_ONE_BLOCK_MAX_N = {16: 572, 32: 416, 40: 360, 64: 256, 80: 208}
BWD_MAX_N = {16: 1704, 32: 1656, 40: 1636, 64: 1564, 80: 1520}
BWD_DESIGNS = {"one-block": 0, "two-kernel": 1, "tensor-core": 2}
# The design bf16 runs.  Only chip_smoke.py sets another ("one-block" or
# "two-kernel", the FMA designs bf16 ran before), to time the designs side by
# side; no config field or flag reaches it.
_bwd_bf16_design = "tensor-core"
# The block kernel has two designs, chosen by shape (``block_design``).  The
# cluster design (csrc/attention_block.cu) gives every 32 query rows of an
# image one thread block and joins an image's blocks into one cluster of at
# most 8: N <= 256, head width 64, and its [32, C] output tile, the head mean
# and its core's tiles within the shared memory one block may hold.  Its
# attention core has two forms.  bf16 runs the tensor-core core: the head's K
# and V as bf16 in every block of the cluster (each block pushes its rows to
# the others through distributed shared memory), QK^T and P V on mma.sync, S
# in registers, two passes over the keys a head.  float32 runs the FMA core
# (K and V pulled as float32 chunks, a [32, N] float32 tile of S, float32
# products): its gates need full float32 products.  The streamed design
# (csrc/attention_block_streamed.cuh) takes every other shape the shared
# memory allows, at every head width kernel 1 takes (16, 32, 40, 64, 80): a
# first launch writes K and V of every head to a [B, 2, H, N, dh] scratch, a
# second gives each block one tile of 16 or 32 query rows of one image
# across all heads (bf16: kernel 1's tensor-core core streaming K and V from
# the scratch; float32: the FMA core).
BLOCK_ROWS = 32
BLOCK_MAX_CLUSTER = 8
BLOCK_HEAD_DIMS = FWD_HEAD_DIMS
BLOCK_SMEM_LIMIT = 232448   # sm_90's opt-in shared memory a block
BLOCK_DESIGNS = {"fma": 0, "tensor-core": 1, "streamed": 2}
# The core the cluster design runs at bf16; only chip_smoke.py sets "fma",
# to time the earlier one beside it.  No config field or flag reaches it.
_block_bf16_design = "tensor-core"
# the block wrapper's calls that ran the streamed design, by head width (each
# also counts in ``block_launches``)
block_streamed_launches = {dh: 0 for dh in BLOCK_HEAD_DIMS}
# The sequence-parallel kernel takes Np <= SEQ_MAX_NP[dh] at head width dh
# (``seq_smem_bytes``; N = 1025 padded to 8 ranks is 1032).  bf16 runs its
# tensor-core design (16 query rows a block; S in registers; the
# [16, Np] float32 head mean in shared memory).  float32 runs the FMA design,
# which keeps a [QB, Np] float32 tile of S (and one of the head mean) in
# shared memory, QB = 32 query rows or 16 where 32 do not fit: with the head
# mean (33 * ceil4(Np) + Np + 16 dh + 64 (dh + 4) + 32) floats at QB = 16,
# which sets every width's limit (16: 1660, 32: 1624, 40: 1604, 64: 1548,
# 80: 1512), since both dtypes take the same Np.
SEQ_DESIGNS = {"fma": 0, "tensor-core": 1}
# The design bf16 runs; only chip_smoke.py sets "fma", to time the earlier one
_seq_bf16_design = "tensor-core"
# The forward kernel's query tile (``q_block``) is 32 rows or 16.  With the
# head mean or the rollout its FMA design keeps two [q_block, N] float32
# tiles in shared memory (csrc/masked_attention.cuh: smem_bytes): N <= 780
# at 32 rows and N <= 1548 at 16 at head width 64, N <= 756 and N <= 1512 at
# 80 (852 / 1660 at 16, 828 / 1624 at 32, 816 / 1604 at 40); the plain
# variant's one tile fits both past that (2928 and 1516 at 64, 2856 and 1472
# at 80).  The tensor-core design takes the same (q_block, N) pairs as one or
# two m16 tiles (16 rows by default, which fit its own tiles to N = 2272 in
# bf16 and 2688 in int8 at 64, 1888 and 2560 at 80, 2848 / 3008 at 16, 2592
# / 2848 at 32 and 2368 / 2784 at 40).
# The split-tensor kernel tiles the same way.
Q_BLOCKS = (16, 32)
# The forward kernel has two designs.  bf16 and int8 qkv run the tensor-core
# design: 16 query rows a block of 8 warps, QK^T on mma.sync (bf16, or s8
# with exact int32 sums under int8_io), P V on bf16 mma.sync, S in
# registers, K and V staged by cp.async into per-warp rings.  float32 runs
# the FMA design (a [q_block, N] float32 tile of S in shared memory, float32
# products): its gates need full float32 products.
FWD_DESIGNS = {"fma": 0, "tensor-core": 1}
# The design bf16 and int8 qkv run; only chip_smoke.py sets "fma", to time
# the earlier one beside it.  No config field or flag reaches it.
_fwd_bf16_design = "tensor-core"
# The split-tensor kernel takes N <= V1_MAX_N[dh] at head width dh
# (``v1_smem_bytes``; 1536 at 64).  bf16 runs its tensor-core design (kernel
# 1's: 16 query rows a block of 8 warps, S in registers, the [16, N] float32
# head mean in shared memory); float32 runs the FMA design (a [q_block, N]
# float32 tile of S in shared memory, 32 query rows, or 16 past N = 780 with
# the head mean at width 64).
V1_DESIGNS = {"fma": 0, "tensor-core": 1}
# The design bf16 runs; only chip_smoke.py sets "fma", to time the earlier
# one beside it.  No config field or flag reaches it.
_v1_bf16_design = "tensor-core"


def _scales_kind(qkv, scales, num_heads):
    """Which int8 option the call asks for, with the TPU entry point's
    checks: int8 qkv needs [4] per-tensor or [3H + 1] per-head scales
    (sq.., sk.., sv.., 1/s_out); float qkv with scales = [1/s_out] is
    int8_out."""
    if qkv.dtype == torch.int8:
        if scales is None:
            raise ValueError("int8 qkv requires the scales vector")
        if scales.numel() == 3 * num_heads + 1 and num_heads > 1:
            return _PER_HEAD
        if scales.numel() != 4:
            raise ValueError(
                f"scales must have 4 (per-tensor) or {3 * num_heads + 1} "
                f"(per-head) entries, got {scales.numel()}")
        return _PER_TENSOR
    if scales is None:
        return _NO_SCALES
    if scales.numel() != 1:
        raise ValueError("int8-out mode takes scales = [1/s_out], got "
                         f"{scales.numel()} entries")
    return _OUT_ONLY


def fwd_design(dtype) -> str:
    """The CUDA forward design for qkv of ``dtype``: "tensor-core" for
    bfloat16 and int8 (the serving and training paths'), "fma" for float32
    (its gates need full float32 products)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA attention kernel takes bfloat16, float32 "
                        f"or int8 qkv, got {dtype}")
    return "fma" if dtype == torch.float32 else _fwd_bf16_design


_WIDTH_NAMES = {"fused": "kernel 1 (masked_attention_fused)",
                "backward": "the attention backward kernel",
                "block": "the attention block kernel",
                "seq": "the sequence-parallel attention kernel",
                "v1": "the split-tensor attention kernel (v1)",
                "variants": "the attn_variants ablation kernels"}


def check_head_width(kernel: str, dh: int) -> int:
    """``dh`` if the CUDA kernel ``kernel`` (a key of ``_WIDTH_NAMES``) is
    compiled for that head width, else ValueError naming the widths it
    takes: ``FWD_HEAD_DIMS`` for kernel 1, ``BWD_HEAD_DIMS`` for the
    backward, ``SEQ_HEAD_DIMS`` for the sequence-parallel kernel,
    ``V1_HEAD_DIMS`` for the split-tensor kernel, ``BLOCK_HEAD_DIMS`` for
    the block kernel, ``HEAD_DIM`` for the others (the ablation kernels).
    Needs no CUDA."""
    widths = {"fused": FWD_HEAD_DIMS, "backward": BWD_HEAD_DIMS,
              "seq": SEQ_HEAD_DIMS, "v1": V1_HEAD_DIMS,
              "block": BLOCK_HEAD_DIMS}.get(kernel, (HEAD_DIM,))
    if dh not in widths:
        which = ", ".join(map(str, widths))
        raise ValueError(f"{_WIDTH_NAMES[kernel]} is compiled for head "
                         f"width{'s' if len(widths) > 1 else ''} {which}, "
                         f"got {dh}")
    return dh


def _check_shapes(qkv, bg, joint, num_heads):
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3C] with C divisible by "
                         f"num_heads={num_heads}, got {tuple(qkv.shape)}")
    b, n, _ = qkv.shape
    if tuple(bg.shape) != (b, n):
        raise ValueError(f"bg must be [B, N] = {(b, n)}, got "
                         f"{tuple(bg.shape)}")
    if joint is not None and tuple(joint.shape) != (b, n, n):
        raise ValueError(f"joint must be [B, N, N] = {(b, n, n)}, got "
                         f"{tuple(joint.shape)}")


def masked_attention_fused_ref(qkv, bg, joint=None, scales=None, *,
                               num_heads: int, scale: float,
                               mask_value: float = -100.0,
                               with_headmean: bool = False,
                               clamp_softmax: bool = False, hm_dtype=None,
                               float_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel.

    qkv: [B, N, 3C], layout [q|k|v] with heads contiguous inside each;
    bg: [B, N] background indicator (1.0 = background).  Returns
    (out [B, N, C], cls_row [B, N]) and, third, the rollout update
    J' = (hm @ J + J) / 2 when ``joint`` [B, N, N] is given, else the head-mean
    probabilities [B, N, N] (dtype ``hm_dtype`` or the float dtype) when
    ``with_headmean``.  J' has joint's dtype.

    The key mask is the rank-1 form (1 - bg_q) * (mask_value * bg_k), which
    softmax cannot tell from the reference's symmetric pair mask.  S, the
    softmax, the head mean and the rollout product are computed in at least
    float32; P (or the unnormalized exponentials when no head mean is needed)
    is rounded to V's dtype before P.V, as the TPU kernel does.

    int8 options (``scales``, as the TPU kernel):
      int8_io, int8 qkv with scales [sq, sk, sv, 1/s_out] or per head
        [sq_0.., sk_0.., sv_0.., 1/s_out]: S = (q.k) * ((sq * sk) * scale)
        with the exact integer dot, V = (v * sv) rounded to bf16 (so P is
        rounded to bf16 too), out int8; cls_row and the head mean in
        ``float_dtype``;
      int8_out, float qkv with scales [1/s_out]: out int8.
    The int8 out is clip(round(O * (1/s_out)), +-127), round half to even.
    Without them out and cls_row have qkv's dtype.
    """
    _check_shapes(qkv, bg, joint, num_heads)
    kind = _scales_kind(qkv, scales, num_heads)
    int8_io = kind in (_PER_TENSOR, _PER_HEAD)
    b, n, c3 = qkv.shape
    c = c3 // 3
    h = num_heads
    f_dtype = float_dtype if int8_io else qkv.dtype
    acc = torch.float32 if int8_io else torch.promote_types(qkv.dtype,
                                                            torch.float32)
    q, k, v = qkv.reshape(b, n, 3, h, c // h).permute(
        2, 0, 3, 1, 4)                                     # [B, H, N, dh]
    if int8_io:
        sc = scales.reshape(-1).to(torch.float32)
        if kind == _PER_HEAD:
            sq, sk, sv = sc[:h], sc[h:2 * h], sc[2 * h:3 * h]
        else:
            sq, sk, sv = (sc[i].expand(h) for i in range(3))
        s_scale = (sq * sk) * torch.tensor(scale, dtype=torch.float32)
        s32 = torch.matmul(q.to(torch.float32), k.to(torch.float32)
                           .transpose(-1, -2))             # exact integers
        s = s32 * s_scale[None, :, None, None]
        v = (v.to(torch.float32) * sv[None, :, None, None]).to(torch.bfloat16)
    else:
        s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    bgf = bg.to(acc)
    s = s + ((1.0 - bgf)[:, :, None] * (bgf * mask_value)[:, None, :])[:, None]
    s = torch.clamp_max(s, 80.0) if clamp_softmax else \
        s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom
    cls_row = p[:, :, 0, :].sum(dim=1) / num_heads
    need_hm = with_headmean or joint is not None
    if need_hm:
        hm = p.sum(dim=1) / num_heads
        ov = torch.matmul(p.to(v.dtype).to(acc), v.to(acc))
    else:
        ov = torch.matmul(e.to(v.dtype).to(acc), v.to(acc)) / denom
    if kind != _NO_SCALES:
        inv_out = scales.reshape(-1)[-1].to(torch.float32)
        ov = torch.clamp(torch.round(ov.to(torch.float32) * inv_out),
                         -127, 127)
        out_dtype = torch.int8
    else:
        out_dtype = qkv.dtype
    out = ov.to(out_dtype).transpose(1, 2).reshape(b, n, c)
    cls_row = cls_row.to(f_dtype)
    if joint is not None:
        jt = torch.promote_types(joint.dtype, torch.float32)
        jf = joint.to(jt)
        newj = 0.5 * (torch.matmul(hm.to(joint.dtype).to(jt), jf) + jf)
        return out, cls_row, newj.to(joint.dtype)
    if with_headmean:
        return out, cls_row, hm.to(hm_dtype or f_dtype)
    return out, cls_row


def masked_attention_fused(qkv, bg, joint=None, scales=None, *,
                           num_heads: int, scale: float,
                           mask_value: float = -100.0,
                           with_headmean: bool = False,
                           clamp_softmax: bool = False, hm_dtype=None,
                           float_dtype=torch.bfloat16, q_block: int = 0):
    """Same contract as ``masked_attention_fused_ref``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (bf16, float32 or int8
    qkv, head width 16, 32, 40, 64 or 80 (``FWD_HEAD_DIMS``), bg float32 or
    bf16, joint
    float32, scales float32) or raise.

    ``q_block`` is the number of query rows a thread block owns: 16 or 32
    forces it, and a forced 32 past N = 780 (head width 64) or N = 756 (80)
    with the head mean or the rollout (where the FMA design's two [32, N]
    float32 tiles do not fit) raises with the bytes it needs, in either
    design.  0 picks 32 where the tiles fit and 16 past that in the FMA
    design, and 16 (one m16 tile, two blocks an SM) in the tensor-core
    design.  The results do not depend on
    it beyond the order of float sums in the FMA design, and not at all in
    the tensor-core design (bit for bit; the rollout update to 1e-6)."""
    global launches
    if q_block not in (0,) + Q_BLOCKS:
        raise ValueError(f"q_block must be 0 (auto) or one of {Q_BLOCKS}, "
                         f"got {q_block}")
    kw = dict(num_heads=num_heads, scale=scale, mask_value=mask_value,
              with_headmean=with_headmean, clamp_softmax=clamp_softmax,
              hm_dtype=hm_dtype, float_dtype=float_dtype)
    if qkv.device.type == "cpu":
        return masked_attention_fused_ref(qkv, bg, joint, scales, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"masked_attention_fused: no kernel for device "
                         f"{qkv.device}")
    _check_shapes(qkv, bg, joint, num_heads)
    kind = _scales_kind(qkv, scales, num_heads)
    tensors = [t for t in (qkv, bg, joint, scales) if t is not None]
    if any(t.device != qkv.device for t in tensors):
        raise ValueError("qkv, bg, joint and scales must be on the same device")
    if any(t.requires_grad for t in tensors):
        raise ValueError("masked_attention_fused is not differentiable; call "
                         "it without gradient tracking, or use "
                         "fused_attention_diff")
    design = fwd_design(qkv.dtype)
    if not bg.is_floating_point() or bg.dtype == torch.float64:
        raise TypeError(f"bg must be a float32/bfloat16 tensor, got {bg.dtype}")
    if scales is not None and (scales.dtype != torch.float32
                               or not scales.is_contiguous()):
        raise TypeError("scales must be a contiguous float32 tensor")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if design == "tensor-core" and qkv.data_ptr() % 16:
        raise ValueError("the tensor-core attention kernel needs qkv 16-byte "
                         "aligned")
    b, n, c3 = qkv.shape
    c = c3 // 3
    dh = check_head_width("fused", c // num_heads)
    if joint is not None:
        if joint.dtype != torch.float32 or not joint.is_contiguous():
            raise TypeError("joint must be a contiguous float32 tensor")
        mode = _ROLLOUT
    else:
        mode = _HEADMEAN if with_headmean else _PLAIN
    int8_io = kind in (_PER_TENSOR, _PER_HEAD)
    f_dtype = float_dtype if int8_io else qkv.dtype
    hm_dtype = hm_dtype or f_dtype
    for name, dt in (("float_dtype", f_dtype), ("hm_dtype", hm_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {dt}")

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    dev = qkv.device
    bg32 = bg.to(torch.float32).contiguous()
    out = torch.empty((b, n, c), dtype=torch.int8 if kind else qkv.dtype,
                      device=dev)
    cls_row = torch.empty((b, n), dtype=f_dtype, device=dev)
    third = None
    if mode == _HEADMEAN:
        third = torch.empty((b, n, n), dtype=hm_dtype, device=dev)
    elif mode == _ROLLOUT:
        third = torch.empty_like(joint)   # never in place: tiles read all of J
    flags = ((_OUT_I8 if kind else 0)
             | (_CLS_BF16 if f_dtype == torch.bfloat16 else 0)
             | (_HM_BF16 if hm_dtype == torch.bfloat16 else 0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vitcam_masked_attention_fused(
            qkv.data_ptr(), bg32.data_ptr(),
            joint.data_ptr() if joint is not None else None,
            out.data_ptr(), cls_row.data_ptr(),
            third.data_ptr() if mode == _HEADMEAN else None,
            third.data_ptr() if mode == _ROLLOUT else None,
            scales.data_ptr() if scales is not None else None, kind,
            b, n, num_heads, dh, float(scale), float(mask_value),
            _DTYPE_CODES[qkv.dtype], mode, int(clamp_softmax), flags, q_block,
            FWD_DESIGNS[design], stream)
    if err:
        msg = lib.vitcam_cuda_error_string(err).decode()
        need = lib.vitcam_masked_attention_smem_bytes(n, mode, q_block, dh)
        raise RuntimeError(
            f"masked_attention_fused kernel launch failed ({design} design): "
            f"cudaError {err} ({msg}); q_block={q_block} at N={n}, head width "
            f"{dh} needs {need} bytes of shared memory (the FMA design's "
            f"tiles, which set the q_block contract of both designs)")
    launches += 1
    width_launches[dh] += 1
    if third is None:
        return out, cls_row
    return out, cls_row, third


def _check_bwd_shapes(qkv, bg, d_out, num_heads):
    _check_shapes(qkv, bg, None, num_heads)
    b, n, c3 = qkv.shape
    if tuple(d_out.shape) != (b, n, c3 // 3):
        raise ValueError(f"d_out must be [B, N, C] = {(b, n, c3 // 3)}, got "
                         f"{tuple(d_out.shape)}")


def masked_attention_bwd_ref(qkv, bg, d_out, *, num_heads: int, scale: float,
                             mask_value: float = -100.0,
                             clamp_softmax: bool = False):
    """Plain PyTorch version of the backward kernel: d_qkv [B, N, 3C] (qkv's
    dtype) of the plain ``masked_attention_fused`` output for the cotangent
    d_out [B, N, C].

    P is recomputed as the forward computes it (rank-1 mask; ``min(S, 80)``
    with ``clamp_softmax``, else the row-max subtract) in at least float32:

      dV = Pb^T dO;  dP = dO V^T;  dS = (P * (dP - rowsum(dP * P))) * scale;
      dQ = dSb K;    dK = dSb^T Q

    with Pb and dSb the values of P and dS rounded to qkv's dtype, d_out read
    in qkv's dtype, and every product summed in at least float32, as the TPU
    kernel.  The clamp differentiates as the identity.  bg gets no gradient,
    and the cls row's cotangent is not an input: its consumers (the mask
    threshold, the top-k indices) have zero derivative."""
    _check_bwd_shapes(qkv, bg, d_out, num_heads)
    b, n, c3 = qkv.shape
    h, dh, dt = num_heads, c3 // 3 // num_heads, qkv.dtype
    acc = torch.promote_types(dt, torch.float32)
    q, k, v = (t.to(acc) for t in qkv.reshape(b, n, 3, h, dh).permute(
        2, 0, 3, 1, 4))                                    # [B, H, N, dh]
    do = d_out.to(dt).reshape(b, n, h, dh).permute(0, 2, 1, 3).to(acc)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    bgf = bg.to(acc)
    s = s + ((1.0 - bgf)[:, :, None] * (bgf * mask_value)[:, None, :])[:, None]
    s = torch.clamp_max(s, 80.0) if clamp_softmax else \
        s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    pb = p.to(dt).to(acc)
    dv = torch.matmul(pb.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))) * scale
    dsb = ds.to(dt).to(acc)
    dq = torch.matmul(dsb, k)
    dk = torch.matmul(dsb.transpose(-1, -2), q)
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(
        b, n, c3).to(dt)


def bwd_design(dtype, n: int, dh: int) -> str:
    """The CUDA backward design for qkv of ``dtype`` at sequence length
    ``n`` and head width ``dh``: "tensor-core" for bf16; for float32
    "one-block" up to ``BWD_ONE_BLOCK_MAX_N[dh]`` and "two-kernel" past it.
    Raises past ``BWD_MAX_N[dh]`` or at a width the backward is not compiled
    for."""
    check_head_width("backward", dh)
    if n > BWD_MAX_N[dh]:
        raise ValueError(f"the CUDA attention backward takes N <= "
                         f"{BWD_MAX_N[dh]} at head width {dh} (its shared "
                         f"memory), got {n}")
    if dtype == torch.bfloat16:
        return _bwd_bf16_design
    return "one-block" if n <= BWD_ONE_BLOCK_MAX_N[dh] else "two-kernel"


def bwd_scratch_shape(design: str, b: int, heads: int, n: int):
    """Shape of the float32 row-statistics scratch a design passes from its
    dQ kernel to its dK / dV kernel, or None (the one-block design)."""
    return None if design == "one-block" else (b, heads, n, 3)


def masked_attention_bwd(qkv, bg, d_out, *, num_heads: int, scale: float,
                         mask_value: float = -100.0,
                         clamp_softmax: bool = False):
    """Same contract as ``masked_attention_bwd_ref``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (bf16 or float32 qkv and
    d_out of one dtype, head width 16, 32, 40, 64 or 80
    (``BWD_HEAD_DIMS``), N <= ``BWD_MAX_N[dh]``, bg float32 or bf16) or
    raise.

    The design follows ``bwd_design``: the tensor-core design for bf16; for
    float32 the one-block design up to ``BWD_ONE_BLOCK_MAX_N[dh]`` and the
    two-kernel design past it (its dQ kernel on 32-row query tiles, or 16
    where those do not fit).  The tensor-core design needs qkv and d_out
    16-byte aligned."""
    global bwd_launches
    kw = dict(num_heads=num_heads, scale=scale, mask_value=mask_value,
              clamp_softmax=clamp_softmax)
    if qkv.device.type == "cpu":
        return masked_attention_bwd_ref(qkv, bg, d_out, **kw)
    if qkv.device.type != "cuda":
        raise ValueError(f"masked_attention_bwd: no kernel for device "
                         f"{qkv.device}")
    _check_bwd_shapes(qkv, bg, d_out, num_heads)
    if bg.device != qkv.device or d_out.device != qkv.device:
        raise ValueError("qkv, bg and d_out must be on the same device")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA attention backward takes bfloat16 or "
                        f"float32 qkv, got {qkv.dtype}")
    if d_out.dtype != qkv.dtype:
        raise TypeError(f"d_out must have qkv's dtype {qkv.dtype}, got "
                        f"{d_out.dtype}")
    if not bg.is_floating_point() or bg.dtype == torch.float64:
        raise TypeError(f"bg must be a float32/bfloat16 tensor, got {bg.dtype}")
    if not (qkv.is_contiguous() and d_out.is_contiguous()):
        raise ValueError("qkv and d_out must be contiguous")
    b, n, c3 = qkv.shape
    dh = c3 // 3 // num_heads
    design = bwd_design(qkv.dtype, n, dh)
    if design == "tensor-core" and (qkv.data_ptr() % 16
                                    or d_out.data_ptr() % 16):
        raise ValueError("the tensor-core attention backward needs qkv and "
                         "d_out 16-byte aligned")

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    bg32 = bg.detach().to(torch.float32).contiguous()
    d_qkv = torch.empty_like(qkv)
    # per row statistics, from the first of two kernels to the second
    shape = bwd_scratch_shape(design, b, num_heads, n)
    stats = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.vitcam_masked_attention_bwd(
            qkv.data_ptr(), bg32.data_ptr(), d_out.data_ptr(),
            d_qkv.data_ptr(), None if stats is None else stats.data_ptr(), b,
            n, num_heads, dh, float(scale), float(mask_value),
            _DTYPE_CODES[qkv.dtype], int(clamp_softmax), BWD_DESIGNS[design],
            stream)
    if err:
        msg = lib.vitcam_cuda_error_string(err).decode()
        need = lib.vitcam_masked_attention_bwd_smem_bytes(
            n, BWD_DESIGNS[design], dh)
        raise RuntimeError(
            f"masked_attention_bwd kernel launch failed ({design} design, "
            f"head width {dh}): cudaError {err} ({msg}); shared memory "
            f"needed {need} bytes")
    bwd_launches += 1
    bwd_width_launches[dh] += 1
    return d_qkv


class _FusedAttentionDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bg, num_heads, scale, mask_value, clamp_softmax):
        out, cls_row = masked_attention_fused(
            qkv.detach(), bg.detach(), num_heads=num_heads, scale=scale,
            mask_value=mask_value, clamp_softmax=clamp_softmax)
        ctx.save_for_backward(qkv, bg)
        ctx.kw = dict(num_heads=num_heads, scale=scale, mask_value=mask_value,
                      clamp_softmax=clamp_softmax)
        ctx.mark_non_differentiable(cls_row)
        return out, cls_row

    @staticmethod
    def backward(ctx, d_out, _d_cls):
        qkv, bg = ctx.saved_tensors
        d_qkv = masked_attention_bwd(qkv.detach(), bg.detach(),
                                     d_out.to(qkv.dtype).contiguous(),
                                     **ctx.kw)
        return d_qkv, None, None, None, None, None


def fused_attention_diff(qkv, bg, *, num_heads: int, scale: float,
                         mask_value: float = -100.0,
                         clamp_softmax: bool = False):
    """Differentiable plain fused attention, (out [B, N, C], cls_row [B, N]).

    Forward: ``masked_attention_fused`` without gradient tracking; only
    (qkv, bg) are kept for the backward.  Backward: ``masked_attention_bwd``,
    which recomputes P; the gradient reaches qkv only.  cls_row is marked
    non-differentiable and bg gets no gradient: both are consumed through
    thresholds and top-k indices alone.  On CUDA tensors both directions
    launch their kernels, on CPU tensors both run their plain versions.

    On a CUDA tensor the backward kernel takes head widths
    ``BWD_HEAD_DIMS`` and N <= ``BWD_MAX_N[dh]`` (1704 at 16, 1564 at 64,
    1520 at 80;
    the TPU kernel: 640, past which the JAX package trains through XLA) and
    raises past them before the forward runs: nothing here leaves the
    kernels for autograd through the plain version."""
    if qkv.device.type == "cuda":
        dh = qkv.shape[-1] // 3 // num_heads
        try:
            bwd_design(qkv.dtype, qkv.shape[1], dh)
        except ValueError as e:
            raise ValueError(f"fused_attention_diff: {e}; train this shape "
                             f"with attn_impl='eager'") from None
    return _FusedAttentionDiff.apply(qkv, bg, num_heads, scale, mask_value,
                                     clamp_softmax)


def _check_block(xn, tokens, wqkv, bqkv, wproj, bproj, bg, joint, num_heads):
    if xn.dim() != 3 or xn.shape[-1] % num_heads:
        raise ValueError(f"xn must be [B, N, C] with C divisible by "
                         f"num_heads={num_heads}, got {tuple(xn.shape)}")
    b, n, c = xn.shape
    for name, t, shape in (("tokens", tokens, (b, n, c)),
                           ("wqkv", wqkv, (3 * c, c)),
                           ("bqkv", bqkv, (3 * c,)), ("wproj", wproj, (c, c)),
                           ("bproj", bproj, (c,)), ("bg", bg, (b, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if joint is not None and tuple(joint.shape) != (b, n, n):
        raise ValueError(f"joint must be [B, N, N] = {(b, n, n)}, got "
                         f"{tuple(joint.shape)}")


def _ceil(x, m):
    return -(-x // m) * m


def block_smem_bytes(design, dtype, n, c, head_dim=HEAD_DIM, rollout=True,
                     q_block=BLOCK_ROWS) -> int:
    """Dynamic shared memory a block of the block kernel's ``design`` takes
    at (N, C, head width, rollout), as the CUDA sources compute it
    (``vitcam_attention_block_smem_bytes`` for the cluster design's cores,
    ``vitcam_attention_block_streamed_smem_bytes`` for the streamed design,
    whose row tile is ``q_block``, 16 or 32).  Needs no CUDA.

    The cluster design (csrc/attention_block.cu), 32 rows a block: "fma"
    (layout) the [32, C] output tile, the [32, N] head mean, q, the block's
    K and V rows, the cls and key-mask rows, then the larger of the GEMM
    staging and the [32, N] S tile with a 64-key chunk; "tensor-core"
    (tc_layout, bf16) the output tile, the head mean, the whole head's K
    and V, q, the cls and key-mask rows, the row statistics, then the larger
    of the GEMM staging and the partial O tiles.  The streamed design
    (csrc/attention_block_streamed.cuh): bf16 the [q_block, C] q / output
    tile, the head mean, the cls and key-mask rows, the warps' row
    statistics, then the larger of the eight warps' rings and the GEMM
    staging; float32 the q / output tile, the head mean, the cls and
    key-mask rows, then the larger of the GEMM staging and the [q_block, N]
    S tile with a 64-key chunk."""
    bf = dtype == torch.bfloat16
    esz, pad = (2, 8) if bf else (4, 4)
    stage = 2 * (32 + 384) * 40 * 2 if bf else (32 * 36 + 32 * 388) * 4
    ns, nk = _ceil(n, 4), _ceil(n, 16)
    hs = _ceil(n, 32) + 8
    if design == "streamed":
        qb = q_block
        if bf:
            w = _ceil(head_dim, 16)
            pitch = 64 if head_dim == 64 else w if (w // 8) % 2 else w + 8
            ring = max(4 * 16 * pitch * 2, qb // 16 * 16 * (w + 8) * 4)
            return (qb * (c + pad) * esz + (qb * hs * 4 if rollout else 0)
                    + 2 * nk * 4 + 8 * qb * 2 * 4 + 2 * qb * 4
                    + max(8 * ring, stage))
        return (qb * (c + pad) * esz + (qb * ns * 4 if rollout else 0)
                + 2 * ns * 4 + 2 * qb * 4
                + max(stage, (qb * ns + 64 * (head_dim + 4)) * 4))
    if design == "tensor-core":
        return (32 * (c + 8) * 2 + (32 * hs * 4 if rollout else 0)
                + 2 * _ceil(n, 32) * 64 * 2 + 32 * 64 * 2 + 2 * nk * 4
                + 2 * 32 * 4 + 4 * 32 * 2 * 4
                + max(stage, 4 * 32 * 72 * 4))
    return (32 * (c + pad) * esz + (32 * ns * 4 if rollout else 0)
            + 32 * 64 * 4 + 2 * 32 * 68 * 4 + 2 * ns * 4 + 2 * 32 * 4
            + max(stage, (32 * ns + 64 * 68) * 4))


def _block_dtype(dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA block kernel takes bfloat16 or float32, "
                        f"got {dtype}")


def block_design(dtype, n, c, head_dim=HEAD_DIM, rollout=True) -> str:
    """The CUDA block kernel's design for xn of ``dtype`` [B, N, C] at head
    width ``head_dim``, with the rollout or without.  The rule, and the only
    one: the cluster design where it takes the shape (head width 64, N <=
    ``BLOCK_MAX_CLUSTER`` * 32, its layout within ``BLOCK_SMEM_LIMIT``):
    "tensor-core" for bfloat16 (``_block_bf16_design`` = "fma" its FMA
    core), "fma" for float32; else "streamed" where its layout fits at 16
    query rows a block.  A shape past both raises, naming the bytes; the
    wrapper never falls back to another route."""
    _block_dtype(dtype)
    check_head_width("block", head_dim)
    cluster = "fma" if dtype == torch.float32 else _block_bf16_design
    if head_dim == HEAD_DIM and -(-n // BLOCK_ROWS) <= BLOCK_MAX_CLUSTER and \
            block_smem_bytes(cluster, dtype, n, c, head_dim,
                             rollout) <= BLOCK_SMEM_LIMIT:
        return cluster
    need = block_smem_bytes("streamed", dtype, n, c, head_dim, rollout, 16)
    if need > BLOCK_SMEM_LIMIT:
        name = str(dtype).split(".")[-1]
        raise ValueError(
            f"the CUDA block kernel takes no N={n}, C={c} at head width "
            f"{head_dim} ({name}, rollout={rollout}): its streamed design "
            f"needs {need} bytes of shared memory a block at 16 query rows, "
            f"past the {BLOCK_SMEM_LIMIT} one may hold; serve this shape "
            "without attn_block_fusion")
    return "streamed"


def block_rows(dtype, n, c, head_dim=HEAD_DIM, rollout=True) -> int:
    """Query rows a block of the streamed design owns at this shape: 32
    where its layout fits, else 16."""
    return 32 if block_smem_bytes("streamed", dtype, n, c, head_dim, rollout,
                                  32) <= BLOCK_SMEM_LIMIT else 16


def _largest(fits, step):
    """The largest multiple of ``step`` for which ``fits`` holds (it holds
    for ``step`` and for nothing past the first value where it fails)."""
    v = step
    while fits(v + step):
        v += step
    return v


def _streamed_fits(dtype, n, c, dh):
    return block_smem_bytes("streamed", dtype, n, c, dh, True,
                            16) <= BLOCK_SMEM_LIMIT


# The limits at the zoo's extremes, with the rollout (every (N, C) pair whose
# layout fits runs; ``block_design`` holds the rule): the longest N at the
# widest C (ViT-H/14's 1280 in 16 heads of 80), and the widest C (heads of
# 64) at the longest N (ViT-L/16@512's 1025).
BLOCK_MAX_N = {dt: _largest(lambda n: _streamed_fits(dt, n, 1280, 80), 1)
               for dt in (torch.bfloat16, torch.float32)}
BLOCK_MAX_C = {dt: _largest(lambda c: _streamed_fits(dt, 1025, c, 64), 64)
               for dt in (torch.bfloat16, torch.float32)}


def attention_block_fused_plain(xn, tokens, wqkv, bqkv, wproj, bproj, bg,
                                joint=None, *, num_heads: int, scale: float,
                                mask_value: float = -100.0,
                                clamp_softmax: bool = False):
    """Plain PyTorch version of the block kernel.

    xn (the LayerNorm output) and tokens (the residual stream) [B, N, C];
    wqkv [3C, C] and wproj [C, C] in the torch layout [out, in] (the TPU
    kernel takes the transposes); bqkv [3C], bproj [C]; bg [B, N]; joint
    [B, N, N] or None.  Returns (tokens + proj(attention(qkv(xn))) in xn's
    type, cls_row [B, N] in xn's type) and, with a joint, J' = (hm @ J + J)
    / 2 in joint's type.

    The roundings of the TPU kernel: qkv sums in float32, gets its bias
    there and is rounded to xn's type; the attention core is
    ``masked_attention_fused_ref`` on that qkv (rank-1 mask, clamp or
    row-max, normalised P rounded before P.V with a joint, unnormalised
    exponentials and a division after it without); its output is rounded to
    xn's type before proj; proj, its bias and the residual add are float32,
    then cast."""
    _check_block(xn, tokens, wqkv, bqkv, wproj, bproj, bg, joint, num_heads)
    acc = torch.promote_types(xn.dtype, torch.float32)
    qkv = (torch.matmul(xn.to(acc), wqkv.to(acc).t())
           + bqkv.to(acc)).to(xn.dtype)
    res = masked_attention_fused_ref(
        qkv, bg, joint, num_heads=num_heads, scale=scale,
        mask_value=mask_value, clamp_softmax=clamp_softmax)
    proj = torch.matmul(res[0].to(acc), wproj.to(acc).t()) + bproj.to(acc)
    return ((tokens.to(acc) + proj).to(xn.dtype),) + tuple(res[1:])


def attention_block_fused(xn, tokens, wqkv, bqkv, wproj, bproj, bg,
                          joint=None, *, num_heads: int, scale: float,
                          mask_value: float = -100.0,
                          clamp_softmax: bool = False):
    """Same contract as ``attention_block_fused_plain``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise.  The kernel takes
    xn, tokens, weights and biases all float32 or all bfloat16, contiguous;
    head width 16, 32, 40, 64 or 80 (``BLOCK_HEAD_DIMS``); any (N, C)
    whose layout fits a block's shared memory in the design ``block_design``
    picks (the cluster design, or the streamed design past it:
    ``BLOCK_MAX_N`` and ``BLOCK_MAX_C`` give the limits at the zoo's
    extremes); bg float32 or bfloat16; joint float32.
    It reads the weights in the torch layout: no transposed copy is made.
    The streamed design allocates a [B, 2, H, N, dh] scratch of xn's type
    for K and V."""
    global block_launches
    kw = dict(num_heads=num_heads, scale=scale, mask_value=mask_value,
              clamp_softmax=clamp_softmax)
    args = (xn, tokens, wqkv, bqkv, wproj, bproj)
    if xn.device.type == "cpu":
        return attention_block_fused_plain(*args, bg, joint, **kw)
    if xn.device.type != "cuda":
        raise ValueError(f"attention_block_fused: no kernel for device "
                         f"{xn.device}")
    _check_block(*args, bg, joint, num_heads)
    given = [t for t in args + (bg, joint) if t is not None]
    if any(t.device != xn.device for t in given):
        raise ValueError("attention_block_fused: all operands must be on "
                         "xn's device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        raise ValueError("attention_block_fused is not differentiable; call "
                         "it without gradient tracking")
    if xn.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != xn.dtype for t in args):
        raise TypeError("attention_block_fused takes xn, tokens, weights and "
                        "biases all float32 or all bfloat16, got "
                        f"{[t.dtype for t in args]}")
    if not bg.is_floating_point() or bg.dtype == torch.float64:
        raise TypeError(f"bg must be a float32/bfloat16 tensor, got {bg.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in args):
        raise ValueError("attention_block_fused: operands must be contiguous "
                         "and 16-byte aligned")
    b, n, c = xn.shape
    dh = c // num_heads
    rollout = joint is not None
    design = block_design(xn.dtype, n, c, dh, rollout)
    if rollout and (joint.dtype != torch.float32
                    or not joint.is_contiguous()):
        raise TypeError("joint must be a contiguous float32 tensor")

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    bg32 = bg.to(torch.float32).contiguous()
    out = torch.empty_like(xn)
    cls_row = torch.empty((b, n), dtype=xn.dtype, device=xn.device)
    # never in place: every block of an image reads all of J
    newj = torch.empty_like(joint) if rollout else None
    ptrs = (xn.data_ptr(), tokens.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            bg32.data_ptr(), joint.data_ptr() if rollout else None)
    outs = (out.data_ptr(), cls_row.data_ptr(),
            newj.data_ptr() if rollout else None)
    code = _DTYPE_CODES[xn.dtype]
    with torch.cuda.device(xn.device):
        stream = torch.cuda.current_stream(xn.device).cuda_stream
        if design == "streamed":
            q_block = block_rows(xn.dtype, n, c, dh, rollout)
            kv = torch.empty((b, 2, num_heads, n, dh), dtype=xn.dtype,
                             device=xn.device)
            err = lib.vitcam_attention_block_streamed(
                *ptrs, kv.data_ptr(), *outs, b, n, num_heads, dh,
                float(scale), float(mask_value), code, int(clamp_softmax),
                q_block, stream)
            need = lib.vitcam_attention_block_streamed_smem_bytes(
                n, num_heads, dh, int(rollout), code, q_block)
        else:
            err = lib.vitcam_attention_block_fused(
                *ptrs, *outs, b, n, num_heads, dh, float(scale),
                float(mask_value), code, int(clamp_softmax),
                -(-n // BLOCK_ROWS), BLOCK_DESIGNS[design], stream)
            need = lib.vitcam_attention_block_smem_bytes(
                n, num_heads, int(rollout), code, BLOCK_DESIGNS[design])
    if err:
        msg = lib.vitcam_cuda_error_string(err).decode()
        raise RuntimeError(
            f"attention_block_fused kernel launch failed ({design} design): "
            f"cudaError {err} ({msg}); shared memory needed {need} bytes")
    block_launches += 1
    if design == "streamed":
        block_streamed_launches[dh] += 1
    if newj is None:
        return out, cls_row
    return out, cls_row, newj


def _check_seq_shapes(q, kv, bg_q, bg_k, num_heads, n_real):
    if q.dim() != 3 or q.shape[-1] % num_heads:
        raise ValueError(f"q must be [B, NQ, C] with C divisible by "
                         f"num_heads={num_heads}, got {tuple(q.shape)}")
    b, nq, c = q.shape
    if kv.dim() != 3 or kv.shape[0] != b or kv.shape[2] != 2 * c \
            or kv.shape[1] < nq:
        raise ValueError(f"kv must be [B, Np, 2C] = ({b}, Np >= {nq}, "
                         f"{2 * c}), got {tuple(kv.shape)}")
    np_ = kv.shape[1]
    if tuple(bg_q.shape) != (b, nq) or tuple(bg_k.shape) != (b, np_):
        raise ValueError(f"bg_q must be {(b, nq)} and bg_k {(b, np_)}, got "
                         f"{tuple(bg_q.shape)} and {tuple(bg_k.shape)}")
    if not 0 <= n_real <= np_:
        raise ValueError(f"n_real must lie in [0, Np = {np_}], got {n_real}")


def seq_design(dtype) -> str:
    """The CUDA sequence-parallel design for q of ``dtype``: "tensor-core"
    for bf16, "fma" for float32 (its gates need full float32 products)."""
    return _seq_bf16_design if dtype == torch.bfloat16 else "fma"


def seq_smem_bytes(np_, dh, with_hm=True, design="fma") -> int:
    """Dynamic shared memory a block of the sequence-parallel kernel's
    ``design`` takes at Np keys and head width ``dh``, with the head mean or
    without, as csrc/masked_attention_seq.cuh computes it
    (``vitcam_masked_attention_seq_smem_bytes``).  Needs no CUDA.

    "fma" (smem_bytes): the [QB, dh] q tile, a 64-key chunk of K or V at
    pitch dh + 4, the [QB, Np] S tile and, with the head mean, the [QB, Np]
    head-mean tile, the row-0 and key-mask rows and two [QB] vectors, all
    float32, at QB = 32 where that fits ``BLOCK_SMEM_LIMIT``, else 16.
    "tensor-core" (tc_smem_bytes): eight warps' rings (two stages of a
    16-key K and V chunk in bf16 rows of the tile pitch, or the warp's
    [16, width + 8] float32 O tile, whichever is larger), the key-mask and
    row-0 rows, the warps' row statistics, two [16] vectors, the [16, Np]
    head mean at a pitch of ceil32(Np) + 8, and past width 64 the [16,
    pitch] bf16 Q tile."""
    if design == "tensor-core":
        w = _ceil(dh, 16)
        pitch = 64 if dh == 64 else w if (w // 8) % 2 else w + 8
        ring = max(4 * 16 * pitch * 2, 16 * (w + 8) * 4)
        floats = 2 * _ceil(np_, 16) + 8 * 16 * 2 + 2 * 16
        if with_hm:
            floats += 16 * (_ceil(np_, 32) + 8)
        return 8 * ring + floats * 4 + (0 if dh == 64 else 16 * pitch * 2)
    ns = _ceil(np_, 4)

    def fma(qb):
        return 4 * (qb * dh + 64 * (dh + 4) + qb * ns * (2 if with_hm else 1)
                    + ns + np_ + 2 * qb)
    return fma(32) if fma(32) <= BLOCK_SMEM_LIMIT else fma(16)


def _seq_fits(np_, dh):
    return all(seq_smem_bytes(np_, dh, True, d) <= BLOCK_SMEM_LIMIT
               for d in SEQ_DESIGNS)


# The longest padded token axis each width takes: both designs' layouts with
# the head mean within the shared memory a block may hold
SEQ_MAX_NP = {dh: _largest(lambda n, dh=dh: _seq_fits(n, dh), 1)
              for dh in SEQ_HEAD_DIMS}


def masked_attention_seq_local_ref(q, kv, bg_q, bg_k, *, num_heads: int,
                                   scale: float, mask_value: float = -100.0,
                                   with_headmean: bool = False,
                                   clamp_softmax: bool = False, hm_dtype=None,
                                   n_real: int = 0):
    """Plain PyTorch version of the sequence-parallel kernel.

    q: [B, NQ, C], this rank's query rows; kv: [B, Np, 2C], the K | V rows
    of every rank (heads contiguous inside each half); bg_q [B, NQ] and bg_k
    [B, Np] background indicators; ``n_real`` the unpadded token count (0:
    Np).  Returns (out [B, NQ, C], row0 [B, Np]) in q's dtype and, with
    ``with_headmean``, hm [B, NQ, Np] in ``hm_dtype`` or q's dtype.

    S = q k^T * scale + (1 - bg_q) * (mask_value * bg_k) + kill, with kill =
    -1e9 on key columns >= n_real: padded keys are removed outright, not
    masked at mask_value.  Then ``min(S, 80)`` or the row-max subtraction,
    E = exp(S), and the row sum is kept above 1e-30.  row0 is the head-mean
    normalised row of the LOCAL row 0, the cls row only on the rank that
    holds global row 0.  With the head mean P = E / sum is rounded to V's
    dtype before P.V; without it E is rounded and the product divided
    afterwards, as the TPU kernel orders them.  Everything is computed in at
    least float32."""
    _check_seq_shapes(q, kv, bg_q, bg_k, num_heads, n_real)
    b, nq, c = q.shape
    np_ = kv.shape[1]
    h, dh = num_heads, c // num_heads
    acc = torch.promote_types(q.dtype, torch.float32)
    qh = q.reshape(b, nq, h, dh).permute(0, 2, 1, 3).to(acc)
    k, v = kv.reshape(b, np_, 2, h, dh).permute(2, 0, 3, 1, 4)
    s = torch.matmul(qh, k.to(acc).transpose(-1, -2)) * scale
    kill = torch.zeros((np_,), dtype=acc, device=q.device)
    kill[(n_real or np_):] = -1e9
    s = s + ((1.0 - bg_q.to(acc))[:, :, None]
             * (bg_k.to(acc) * mask_value)[:, None, :])[:, None] + kill
    s = torch.clamp_max(s, 80.0) if clamp_softmax else \
        s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    row0 = (e[:, :, 0, :] / denom[:, :, 0, :]).sum(dim=1) / num_heads
    if with_headmean:
        p = e / denom
        hm = p.sum(dim=1) / num_heads
        ov = torch.matmul(p.to(v.dtype).to(acc), v.to(acc))
    else:
        ov = torch.matmul(e.to(v.dtype).to(acc), v.to(acc)) / denom
    out = ov.to(q.dtype).transpose(1, 2).reshape(b, nq, c)
    if with_headmean:
        return out, row0.to(q.dtype), hm.to(hm_dtype or q.dtype)
    return out, row0.to(q.dtype)


def masked_attention_seq_local(q, kv, bg_q, bg_k, *, num_heads: int,
                               scale: float, mask_value: float = -100.0,
                               with_headmean: bool = False,
                               clamp_softmax: bool = False, hm_dtype=None,
                               n_real: int = 0):
    """Same contract as ``masked_attention_seq_local_ref``.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (q and kv both float32
    or both bfloat16, contiguous, a head width dh of ``SEQ_HEAD_DIMS``, Np
    <= ``SEQ_MAX_NP[dh]``, bg float32 or bf16, hm float32 or bf16) or
    raise: bf16 its tensor-core design (q and kv 16-byte aligned),
    float32 its FMA design."""
    global seq_launches
    kw = dict(num_heads=num_heads, scale=scale, mask_value=mask_value,
              with_headmean=with_headmean, clamp_softmax=clamp_softmax,
              hm_dtype=hm_dtype, n_real=n_real)
    if q.device.type == "cpu":
        return masked_attention_seq_local_ref(q, kv, bg_q, bg_k, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention_seq_local: no kernel for device "
                         f"{q.device}")
    _check_seq_shapes(q, kv, bg_q, bg_k, num_heads, n_real)
    tensors = (q, kv, bg_q, bg_k)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, kv, bg_q and bg_k must be on the same device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("masked_attention_seq_local is not differentiable; "
                         "call it without gradient tracking")
    if q.dtype not in (torch.float32, torch.bfloat16) or kv.dtype != q.dtype:
        raise TypeError(f"the CUDA sequence-parallel kernel takes q and kv "
                        f"both bfloat16 or both float32, got {q.dtype} and "
                        f"{kv.dtype}")
    for bg in (bg_q, bg_k):
        if not bg.is_floating_point() or bg.dtype == torch.float64:
            raise TypeError(f"bg must be a float32/bfloat16 tensor, got "
                            f"{bg.dtype}")
    if not (q.is_contiguous() and kv.is_contiguous()):
        raise ValueError("q and kv must be contiguous")
    b, nq, c = q.shape
    np_ = kv.shape[1]
    dh = check_head_width("seq", c // num_heads)
    if np_ > SEQ_MAX_NP[dh]:
        need = max(seq_smem_bytes(np_, dh, True, d) for d in SEQ_DESIGNS)
        raise ValueError(
            f"the CUDA sequence-parallel kernel takes Np <= "
            f"{SEQ_MAX_NP[dh]} at head width {dh}, got {np_}: with "
            f"the head mean its designs need up to {need} bytes of shared "
            f"memory a block there, past the {BLOCK_SMEM_LIMIT} one may hold")
    hm_dtype = hm_dtype or q.dtype
    if hm_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hm_dtype must be float32 or bfloat16, got "
                        f"{hm_dtype}")
    design = seq_design(q.dtype)
    if design == "tensor-core" and (q.data_ptr() % 16 or kv.data_ptr() % 16):
        raise ValueError("the tensor-core sequence-parallel kernel needs q "
                         "and kv 16-byte aligned")

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    dev = q.device
    bgq32 = bg_q.to(torch.float32).contiguous()
    bgk32 = bg_k.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    # only the block of local row 0 writes row0, and it writes all of it
    row0 = torch.empty((b, np_), dtype=q.dtype, device=dev)
    hm = torch.empty((b, nq, np_), dtype=hm_dtype, device=dev) \
        if with_headmean else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vitcam_masked_attention_seq(
            q.data_ptr(), kv.data_ptr(), bgq32.data_ptr(), bgk32.data_ptr(),
            out.data_ptr(), row0.data_ptr(),
            hm.data_ptr() if with_headmean else None, b, nq, np_,
            n_real or np_, num_heads, dh, float(scale),
            float(mask_value), _DTYPE_CODES[q.dtype], int(with_headmean),
            int(clamp_softmax), int(hm_dtype == torch.bfloat16),
            SEQ_DESIGNS[design], stream)
    if err:
        msg = lib.vitcam_cuda_error_string(err).decode()
        need = lib.vitcam_masked_attention_seq_smem_bytes(
            np_, int(with_headmean), SEQ_DESIGNS[design], dh)
        raise RuntimeError(
            f"masked_attention_seq_local kernel launch failed ({design} "
            f"design): cudaError {err} ({msg}); shared memory needed {need} "
            f"bytes")
    seq_launches += 1
    seq_width_launches[dh] += 1
    if with_headmean:
        return out, row0, hm
    return out, row0


def masked_attention_seq(qkv_local, bg_local, *, group, n_real: int,
                         num_heads: int, scale: float,
                         mask_value: float = -100.0,
                         with_headmean: bool = False,
                         clamp_softmax: bool = False, hm_dtype=None):
    """Sequence-parallel fused masked attention on one rank of a sequence
    group (``parallel.mesh.SeqMesh``; None is a group of one rank).

    qkv_local: [B, NQ, 3C], this rank's rows of a token axis that the caller
    padded to Np = group size * NQ; bg_local: [B, NQ]; ``n_real`` the
    unpadded token count N.  The K | V columns and bg are all-gathered over
    the group, ``masked_attention_seq_local`` runs on the local query rows,
    and the cls row is taken from sequence-rank 0 (a broadcast; only there
    is local row 0 the global one).  Returns (out [B, NQ, C], the local
    rows; cls_row [B, N], the same on every rank; and with ``with_headmean``
    hm [B, NQ, N]): the padded key columns are cut off, the padded query
    rows of the last rank are the caller's to drop."""
    c = qkv_local.shape[-1] // 3
    q = qkv_local[:, :, :c].contiguous()
    kv_l = qkv_local[:, :, c:]
    if group is None or group.inner_size == 1:
        kv, bg_k = kv_l.contiguous(), bg_local
    else:
        kv = group.all_gather(kv_l.contiguous(), dim=1)
        bg_k = group.all_gather(bg_local.contiguous(), dim=1)
    res = masked_attention_seq_local(
        q, kv, bg_local, bg_k, num_heads=num_heads, scale=scale,
        mask_value=mask_value, with_headmean=with_headmean,
        clamp_softmax=clamp_softmax, hm_dtype=hm_dtype, n_real=n_real)
    row0 = res[1]
    if group is not None and group.inner_size > 1:
        row0 = group.inner_broadcast(row0, 0)
    cls_row = row0[:, :n_real]
    if with_headmean:
        return res[0], cls_row, res[2][:, :, :n_real]
    return res[0], cls_row


def _check_v1(q, k, v, bg):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be [B, H, N, dh] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if tuple(bg.shape) != (q.shape[0], q.shape[2]):
        raise ValueError(f"bg must be [B, N] = {(q.shape[0], q.shape[2])}, "
                         f"got {tuple(bg.shape)}")


def v1_smem_bytes(design, dtype, n, head_dim=HEAD_DIM, with_hm=True) -> int:
    """Dynamic shared memory a block of the split-tensor kernel's ``design``
    takes at N and head width ``head_dim``, with the head mean or without,
    as csrc/masked_attention_v1.cuh computes it
    (``vitcam_masked_attention_v1_smem_bytes``).  Needs no CUDA; the FMA
    design's layout is float32 whatever q's ``dtype``.

    "fma" (smem_bytes): the [QB, dh] q tile, a 64-key chunk of K or V at
    pitch dh + 4, the [QB, N] S tile and, with the head mean, the [QB, N]
    head-mean tile, the cls row, the keys' bg and the query rows' bg, all
    float32, at QB = 32 where that fits ``BLOCK_SMEM_LIMIT``, else 16.
    "tensor-core" (tc_smem_bytes): eight warps' rings (two stages of a
    16-key K and V chunk in bf16 rows of the tile pitch, or the warp's
    [16, width + 8] float32 O tile, whichever is larger), the keys' bg and
    the cls sums, the warps' row statistics, the query rows' bg, the [16, N]
    head mean at a pitch of ceil32(N) + 8, and at every width but 64 the
    [16, pitch] bf16 Q tile."""
    del dtype
    if design == "tensor-core":
        w = _ceil(head_dim, 16)
        pitch = 64 if head_dim == 64 else w if (w // 8) % 2 else w + 8
        ring = max(4 * 16 * pitch * 2, 16 * (w + 8) * 4)
        floats = 2 * _ceil(n, 16) + 8 * 16 * 2 + 16
        if with_hm:
            floats += 16 * (_ceil(n, 32) + 8)
        return 8 * ring + floats * 4 + (0 if head_dim == 64
                                        else 16 * pitch * 2)
    ns = _ceil(n, 4)

    def fma(qb):
        return 4 * (qb * head_dim + 64 * (head_dim + 4)
                    + qb * ns * (2 if with_hm else 1) + ns + n + qb)
    return fma(32) if fma(32) <= BLOCK_SMEM_LIMIT else fma(16)


def _v1_fits(n, dh):
    return all(v1_smem_bytes(d, None, n, dh) <= BLOCK_SMEM_LIMIT
               for d in V1_DESIGNS)


# The longest N each width takes: the largest multiple of 16 (the
# tensor-core design's key chunk) at which both designs' layouts with the
# head mean fit the shared memory a block may hold, so that a shape runs in
# float32 and in bf16 alike (16: 1648, 32: 1616, 40: 1600, 64: 1536, 80:
# 1504)
V1_MAX_N = {dh: _largest(lambda n, dh=dh: _v1_fits(n, dh), 16)
            for dh in V1_HEAD_DIMS}


def v1_design(dtype, n: int, head_dim: int = HEAD_DIM) -> str:
    """The CUDA split-tensor design for q of ``dtype`` at sequence length
    ``n`` and head width ``head_dim``: "tensor-core" for bfloat16, "fma" for
    float32 (its gates need full float32 products), both for every N <=
    ``V1_MAX_N[head_dim]``.  Raises past it, naming the bytes, for a width
    that is not compiled and for any other dtype."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA split-tensor attention kernel takes q, k "
                        f"and v all bfloat16 or all float32, got {dtype}")
    check_head_width("v1", head_dim)
    design = _v1_bf16_design if dtype == torch.bfloat16 else "fma"
    if n > V1_MAX_N[head_dim]:
        need = max(v1_smem_bytes(d, dtype, n, head_dim) for d in V1_DESIGNS)
        raise ValueError(
            f"the CUDA split-tensor attention kernel takes N <= "
            f"{V1_MAX_N[head_dim]} at head width {head_dim} (the largest "
            f"multiple of 16 at which its layouts fit the {BLOCK_SMEM_LIMIT} "
            f"bytes of shared memory a block may hold), got {n}: with the "
            f"head mean it needs {need} bytes a block there")
    return design


def masked_attention_ref(q, k, v, bg, *, scale: float,
                         mask_value: float = -100.0,
                         with_headmean: bool = False):
    """Plain PyTorch version of the split-tensor kernel, following the TPU
    kernel line by line.

    q, k, v: [B, H, N, dh]; bg: [B, N] (1.0 = background).  Returns (out
    [B, H, N, dh], cls_row [B, N]) and with ``with_headmean`` the head-mean
    probabilities [B, N, N], all in q's dtype.

      S = q k^T * scale + mask_value * min(bg_i + bg_j, 1)   (pair mask)
      S = S - rowmax(S);  E = exp(S);  P = E / rowsum(E)
      out_h = P_h v_h with P rounded to v's dtype;  cls_row = mean_h P[0]

    in at least float32.  The pair mask reaches every query row, and an
    all-background image gives the unmasked softmax (every logit is shifted
    by mask_value alike)."""
    _check_v1(q, k, v, bg)
    heads = q.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    bgf = bg.to(acc)
    pair = torch.clamp_max(bgf[:, :, None] + bgf[:, None, :], 1.0) * mask_value
    s = s + pair[:, None]
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    cls_row = (p[:, :, 0, :].sum(dim=1) / heads).to(q.dtype)
    out = torch.matmul(p.to(v.dtype).to(acc), v.to(acc)).to(q.dtype)
    if with_headmean:
        return out, cls_row, (p.sum(dim=1) / heads).to(q.dtype)
    return out, cls_row


def masked_attention(q, k, v, bg, *, scale: float, mask_value: float = -100.0,
                     with_headmean: bool = False):
    """Same contract as ``masked_attention_ref``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (q, k, v all float32 or all
    bfloat16, contiguous, head width 16, 32, 40, 64 or 80
    (``V1_HEAD_DIMS``), N <= ``V1_MAX_N[dh]``, bg float32 or bf16) or
    raise: bf16 its tensor-core design (q, k, v 16-byte aligned), float32
    its FMA design (``v1_design``).  It has no backward, as the TPU kernel
    has none."""
    global v1_launches
    kw = dict(scale=scale, mask_value=mask_value, with_headmean=with_headmean)
    if q.device.type == "cpu":
        return masked_attention_ref(q, k, v, bg, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: no kernel for device {q.device}")
    _check_v1(q, k, v, bg)
    tensors = (q, k, v, bg)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and bg must be on the same device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("masked_attention is not differentiable; call it "
                         "without gradient tracking")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA split-tensor attention kernel takes q, k "
                        f"and v all bfloat16 or all float32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not bg.is_floating_point() or bg.dtype == torch.float64:
        raise TypeError(f"bg must be a float32/bfloat16 tensor, got {bg.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    b, h, n, dh = q.shape
    design = v1_design(q.dtype, n, dh)
    if design == "tensor-core" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core split-tensor attention kernel needs "
                         "q, k and v 16-byte aligned")

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    bg32 = bg.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    cls_row = torch.empty((b, n), dtype=q.dtype, device=q.device)
    hm = torch.empty((b, n, n), dtype=q.dtype, device=q.device) \
        if with_headmean else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vitcam_masked_attention_v1(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bg32.data_ptr(),
            out.data_ptr(), cls_row.data_ptr(),
            hm.data_ptr() if with_headmean else None, b, n, h, dh,
            float(scale), float(mask_value), _DTYPE_CODES[q.dtype],
            int(with_headmean), V1_DESIGNS[design], stream)
    if err:
        msg = lib.vitcam_cuda_error_string(err).decode()
        need = lib.vitcam_masked_attention_v1_smem_bytes(
            n, int(with_headmean), V1_DESIGNS[design], dh)
        raise RuntimeError(
            f"masked_attention kernel launch failed ({design} design): "
            f"cudaError {err} ({msg}); shared memory needed {need} bytes")
    v1_launches += 1
    v1_width_launches[dh] += 1
    if with_headmean:
        return out, cls_row, hm
    return out, cls_row
