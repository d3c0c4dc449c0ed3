"""Fused masked multi-head attention with the CAM statistics.

``masked_attention_fused`` is the port of the TPU kernel's entry point
(vision_transformer_cam_tpu/kernels/attention.py: masked_attention_fused),
with its int8 serving options: ``int8_io`` (int8 qkv with per-head or
per-tensor scales, int8 output) and ``int8_out`` (float qkv, int8 output).
On a CUDA tensor it launches the hand-written Hopper kernel
in ``csrc/masked_attention.cu``; on a CPU tensor it runs
``masked_attention_fused_ref``, the plain PyTorch version of the same math,
which the CPU tests hold against the JAX kernel.  There is no fallback from
one to the other.

``launches`` counts the CUDA kernel launches made through the wrapper, so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

launches = 0

# mode codes of the C entry point
_PLAIN, _HEADMEAN, _ROLLOUT = 0, 1, 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# scales-vector kinds and flags of the C entry point
_NO_SCALES, _OUT_ONLY, _PER_TENSOR, _PER_HEAD = 0, 1, 2, 3
_OUT_I8, _CLS_BF16, _HM_BF16 = 1, 2, 4
HEAD_DIM = 64   # the CUDA kernel's head width


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
                           float_dtype=torch.bfloat16):
    """Same contract as ``masked_attention_fused_ref``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (bf16, float32 or int8
    qkv, head width 64, bg float32 or bf16, joint float32, scales float32)
    or raise."""
    global launches
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
        raise ValueError("the CUDA attention kernel has no backward; call it "
                         "under torch.no_grad() or torch.inference_mode()")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA attention kernel takes bfloat16, float32 "
                        f"or int8 qkv, got {qkv.dtype}")
    if not bg.is_floating_point() or bg.dtype == torch.float64:
        raise TypeError(f"bg must be a float32/bfloat16 tensor, got {bg.dtype}")
    if scales is not None and (scales.dtype != torch.float32
                               or not scales.is_contiguous()):
        raise TypeError("scales must be a contiguous float32 tensor")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    b, n, c3 = qkv.shape
    c = c3 // 3
    if c // num_heads != HEAD_DIM:
        raise ValueError(f"the CUDA attention kernel takes head width "
                         f"{HEAD_DIM}, got {c // num_heads}")
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
            b, n, num_heads, c // num_heads, float(scale), float(mask_value),
            _DTYPE_CODES[qkv.dtype], mode, int(clamp_softmax), flags, stream)
    if err:
        msg = lib.vitcam_cuda_error_string(err).decode()
        raise RuntimeError(
            f"masked_attention_fused kernel launch failed: cudaError {err} "
            f"({msg}); shared memory needed "
            f"{lib.vitcam_masked_attention_smem_bytes(n, mode)} bytes")
    launches += 1
    if third is None:
        return out, cls_row
    return out, cls_row, third
