"""Fused masked multi-head attention with the CAM statistics.

``masked_attention_fused`` is the port of the TPU kernel's entry point
(vision_transformer_cam_tpu/kernels/attention.py: masked_attention_fused,
float branches).  On a CUDA tensor it launches the hand-written Hopper kernel
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
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64   # the CUDA kernel's head width


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


def masked_attention_fused_ref(qkv, bg, joint=None, *, num_heads: int,
                               scale: float, mask_value: float = -100.0,
                               with_headmean: bool = False,
                               clamp_softmax: bool = False, hm_dtype=None):
    """Plain PyTorch version of the kernel.

    qkv: [B, N, 3C], layout [q|k|v] with heads contiguous inside each;
    bg: [B, N] background indicator (1.0 = background).  Returns
    (out [B, N, C], cls_row [B, N]) and, third, the rollout update
    J' = (hm @ J + J) / 2 when ``joint`` [B, N, N] is given, else the head-mean
    probabilities [B, N, N] (dtype ``hm_dtype`` or qkv's) when
    ``with_headmean``.  out and cls_row have qkv's dtype, J' has joint's.

    The key mask is the rank-1 form (1 - bg_q) * (mask_value * bg_k), which
    softmax cannot tell from the reference's symmetric pair mask.  S, the
    softmax, the head mean and the rollout product are computed in at least
    float32; P (or the unnormalized exponentials when no head mean is needed)
    is rounded to qkv's dtype before P.V, as the TPU kernel does.
    """
    _check_shapes(qkv, bg, joint, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    acc = torch.promote_types(qkv.dtype, torch.float32)
    q, k, v = qkv.reshape(b, n, 3, num_heads, c // num_heads).permute(
        2, 0, 3, 1, 4)                                     # [B, H, N, dh]
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
    out = ov.to(qkv.dtype).transpose(1, 2).reshape(b, n, c)
    cls_row = cls_row.to(qkv.dtype)
    if joint is not None:
        jt = torch.promote_types(joint.dtype, torch.float32)
        jf = joint.to(jt)
        newj = 0.5 * (torch.matmul(hm.to(joint.dtype).to(jt), jf) + jf)
        return out, cls_row, newj.to(joint.dtype)
    if with_headmean:
        return out, cls_row, hm.to(hm_dtype or qkv.dtype)
    return out, cls_row


def masked_attention_fused(qkv, bg, joint=None, *, num_heads: int,
                           scale: float, mask_value: float = -100.0,
                           with_headmean: bool = False,
                           clamp_softmax: bool = False, hm_dtype=None):
    """Same contract as ``masked_attention_fused_ref``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (bf16 or float32 qkv, head
    width 64, bg float32 or bf16, joint float32) or raise."""
    global launches
    if qkv.device.type == "cpu":
        return masked_attention_fused_ref(
            qkv, bg, joint, num_heads=num_heads, scale=scale,
            mask_value=mask_value, with_headmean=with_headmean,
            clamp_softmax=clamp_softmax, hm_dtype=hm_dtype)
    if qkv.device.type != "cuda":
        raise ValueError(f"masked_attention_fused: no kernel for device "
                         f"{qkv.device}")
    _check_shapes(qkv, bg, joint, num_heads)
    tensors = [t for t in (qkv, bg, joint) if t is not None]
    if any(t.device != qkv.device for t in tensors):
        raise ValueError("qkv, bg and joint must be on the same device")
    if any(t.requires_grad for t in tensors):
        raise ValueError("the CUDA attention kernel has no backward; call it "
                         "under torch.no_grad() or torch.inference_mode()")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA attention kernel takes bfloat16 or float32 "
                        f"qkv, got {qkv.dtype}")
    if not bg.is_floating_point() or bg.dtype == torch.float64:
        raise TypeError(f"bg must be a float32/bfloat16 tensor, got {bg.dtype}")
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
    hm_dtype = hm_dtype or qkv.dtype
    if mode == _HEADMEAN and hm_dtype not in (qkv.dtype, torch.float32):
        raise TypeError(f"hm_dtype must be qkv's dtype or float32, got "
                        f"{hm_dtype}")

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    dev = qkv.device
    bg32 = bg.to(torch.float32).contiguous()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=dev)
    cls_row = torch.empty((b, n), dtype=qkv.dtype, device=dev)
    third = None
    if mode == _HEADMEAN:
        third = torch.empty((b, n, n), dtype=hm_dtype, device=dev)
    elif mode == _ROLLOUT:
        third = torch.empty_like(joint)   # never in place: tiles read all of J
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vitcam_masked_attention_fused(
            qkv.data_ptr(), bg32.data_ptr(),
            joint.data_ptr() if joint is not None else None,
            out.data_ptr(), cls_row.data_ptr(),
            third.data_ptr() if mode == _HEADMEAN else None,
            third.data_ptr() if mode == _ROLLOUT else None,
            b, n, num_heads, c // num_heads, float(scale), float(mask_value),
            _DTYPE_CODES[qkv.dtype], mode, int(clamp_softmax),
            int(hm_dtype == torch.float32), stream)
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
