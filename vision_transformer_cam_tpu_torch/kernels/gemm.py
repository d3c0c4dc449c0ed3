"""The int8 serving GEMM, the fused LayerNorm -> int8 quantize and the fused
MLP kernels.

``linear_int8`` is the port's one int8 GEMM.  It replaces the TPU kernel
vision_transformer_cam_tpu/kernels/gemm.py: linear_int8_fused and also the
XLA-fused int8 GEMMs of ops/quant.py (qlinear, qlinear_requant,
qlinear_gelu_requant), which have no compiler to fuse their epilogues here.
On a CUDA tensor it launches the hand-written kernel in
``csrc/int8_gemm.cu`` (its tensor-core design, ``int8_gemm_design``); on a
CPU tensor it runs ``linear_int8_ref``.

``ln_quant`` replaces kernels/gemm.py: ln_quant (LayerNorm, then the static
int8 quantize, in one pass).  On a CUDA tensor it launches a Triton kernel,
compiled at its first call; on a CPU tensor it runs ``ln_quant_ref``.

``mlp_fused`` and ``mlp_fused_int8`` replace kernels/gemm.py: mlp_fused and
mlp_fused_int8 (fc1 -> GELU -> fc2 in one launch; the [M, HID] hidden tensor
never reaches device memory).  On a CUDA tensor they launch the hand-written
kernel that ``mlp_design`` names: the Hopper design in
``csrc/mlp_fused_wgmma.cu`` (TMA, wgmma) or the earlier one in
``csrc/mlp_fused.cu``; on a CPU tensor they run ``mlp_fused_plain`` and
``mlp_fused_int8_plain``.

There is no fallback from a kernel to its plain version.  Each wrapper
counts its CUDA launches (``linear_int8_launches``, ``ln_quant_launches``,
``mlp_fused_launches``, ``mlp_fused_int8_launches``).
"""

from __future__ import annotations

import math

import torch

linear_int8_launches = 0
ln_quant_launches = 0
mlp_fused_launches = 0
mlp_fused_int8_launches = 0

ROUTES = ("fused", "qlinear")
EPILOGUES = ("float", "requant", "gelu")
_X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The CUDA int8 GEMM has two designs: "tensor-core" (mma.sync.m16n8k32 on
# the int8 tensor cores, 128 x 128 tiles in a three-stage cp.async ring) and
# "dp4a" (the first design, __dp4a on the CUDA cores).  Both run the same
# epilogue on the exact int32 dot and give the same bits.
INT8_GEMM_DESIGNS = {"dp4a": 0, "tensor-core": 1}
# The design every call runs.  Only chip_smoke.py sets "dp4a", to time the
# earlier design beside the new one; no config field or flag reaches it.
_int8_gemm_design = "tensor-core"


def _gelu_f32(y, approximate):
    """jax.nn.gelu's formulas, op for op, in float32."""
    if approximate:
        c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float32)
        cdf = 0.5 * (1.0 + torch.tanh(c * (y + 0.044715 * (y * y * y))))
        return y * cdf
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=torch.float32)
    return 0.5 * y * torch.special.erfc(-y * sqrt_half)


def _quantize(x, a, route):
    """int8 x as given; float x as clip(round(x * inv_a)) on the fused route
    (kernels/gemm.py: _quantize_tile) or clip(round(x / act_scale)) on the
    qlinear route (ops/quant.py: qlinear)."""
    if x.dtype == torch.int8:
        return x
    x32 = x.to(torch.float32)
    t = x32 * a if route == "fused" else x32 / a
    return torch.clamp(torch.round(t), -127, 127).to(torch.int8)


def _check_linear(x, weight_q, col_scale, bias, a_scale, route, epilogue,
                  out_scales, groups):
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: expected one of {ROUTES}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r}: expected one of {EPILOGUES}")
    if weight_q.dtype != torch.int8 or weight_q.dim() != 2:
        raise TypeError(f"weight_q must be int8 [N, K], got {weight_q.dtype} "
                        f"{tuple(weight_q.shape)}")
    n, k = weight_q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x [..., {x.shape[-1]}] does not match weight_q "
                         f"[{n}, {k}]")
    if tuple(col_scale.shape) != (n,):
        raise ValueError(f"col_scale must be [{n}], got "
                         f"{tuple(col_scale.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    if a_scale is None or a_scale.numel() != 1:
        raise ValueError("a_scale must be a one-element tensor")
    if route == "fused" and x.dtype == torch.int8:
        raise TypeError("the fused route quantizes a float x; an int8 x "
                        "takes the qlinear route")
    if epilogue == "requant":
        if out_scales is None or out_scales.numel() != groups or \
                groups < 1 or n % groups:
            raise ValueError(f"requant needs {groups} out_scales dividing "
                             f"N={n} into equal groups")
    elif epilogue == "gelu":
        if out_scales is None or out_scales.numel() != 1:
            raise ValueError("the gelu epilogue needs one out_scale")


def int8_gemm_design(x_dtype) -> str:
    """The CUDA int8 GEMM design for x of ``x_dtype`` (float32, bfloat16 or
    int8): the tensor-core design for every one of them."""
    if x_dtype not in _X_CODES:
        raise TypeError(f"linear_int8 takes float32, bfloat16 or int8 x, got "
                        f"{x_dtype}")
    return _int8_gemm_design


def linear_int8_ref(x, weight_q, col_scale, bias, a_scale, *, route,
                    epilogue="float", out_scales=None, groups=1,
                    gelu_approx=True, out_dtype=torch.float32):
    """Plain PyTorch version of the int8 GEMM.

    x [..., K] float or int8; weight_q int8 [N, K]; col_scale float32 [N];
    bias float32 [N] or None; a_scale a one-element float32 tensor.
      route "fused":   xq = q(x * a_scale)  (a_scale = 1 / act_scale),
                       y = acc * col_scale + bias  (col_scale combined)
      route "qlinear": xq = x if int8 else q(x / a_scale),
                       y = (acc * a_scale) * col_scale + bias  (col_scale
                       the per-channel weight scale)
      epilogue "float":   y in ``out_dtype``
      epilogue "requant": int8 round(y / s_col), s_col the ``groups``
                          ``out_scales`` repeated over equal column groups
      epilogue "gelu":    int8 round(gelu(y) / out_scales[0])
    On the fused route ``out_scales`` holds inverse scales and multiplies
    (round(y * s)), as that route's prologue does: the op order of the TPU
    fused MLP kernel, whose two GEMMs this route repeats.
    The int8 dot is exact: the operands are cast to float64, where every
    partial sum (<= 127^2 K < 2^53) is an integer, then rounded to float32
    as the int32 accumulator's conversion rounds it.
    """
    _check_linear(x, weight_q, col_scale, bias, a_scale, route, epilogue,
                  out_scales, groups)
    n, k = weight_q.shape
    lead = x.shape[:-1]
    a = a_scale.reshape(()).to(torch.float32)
    xq = _quantize(x.reshape(-1, k), a, route)
    acc = torch.matmul(xq.to(torch.float64),
                       weight_q.to(torch.float64).t()).to(torch.float32)
    cs = col_scale.to(torch.float32)
    y = acc * cs if route == "fused" else (acc * a) * cs
    if bias is not None:
        y = y + bias.to(torch.float32)
    if epilogue == "float":
        return y.to(out_dtype).reshape(*lead, n)
    if epilogue == "requant":
        s = out_scales.to(torch.float32).reshape(-1).repeat_interleave(
            n // groups)
    else:
        y = _gelu_f32(y, gelu_approx)
        s = out_scales.to(torch.float32).reshape(())
    t = y * s if route == "fused" else y / s
    q = torch.clamp(torch.round(t), -127, 127).to(torch.int8)
    return q.reshape(*lead, n)


def linear_int8(x, weight_q, col_scale, bias, a_scale, *, route,
                epilogue="float", out_scales=None, groups=1,
                gelu_approx=True, out_dtype=torch.float32):
    """Same contract as ``linear_int8_ref``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (x float32, bfloat16 or int8;
    float outputs float32 or bfloat16) in the design ``int8_gemm_design``
    names, or raise."""
    global linear_int8_launches
    if x.device.type == "cpu":
        return linear_int8_ref(
            x, weight_q, col_scale, bias, a_scale, route=route,
            epilogue=epilogue, out_scales=out_scales, groups=groups,
            gelu_approx=gelu_approx, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"linear_int8: no kernel for device {x.device}")
    _check_linear(x, weight_q, col_scale, bias, a_scale, route, epilogue,
                  out_scales, groups)
    vecs = [t for t in (col_scale, bias, a_scale, out_scales)
            if t is not None]
    if any(t.device != x.device for t in [weight_q] + vecs):
        raise ValueError("linear_int8: all operands must be on x's device")
    if any(t.dtype != torch.float32 for t in vecs):
        raise TypeError("col_scale, bias, a_scale and out_scales must be "
                        "float32")
    design = int8_gemm_design(x.dtype)
    if epilogue == "float" and out_dtype not in _OUT_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if not (x.is_contiguous() and weight_q.is_contiguous()):
        raise ValueError("x and weight_q must be contiguous")
    n, k = weight_q.shape
    lead = x.shape[:-1]
    m = x.numel() // k
    if m == 0:
        raise ValueError("linear_int8: empty x")
    out_dt = out_dtype if epilogue == "float" else torch.int8
    out = torch.empty((m, n), dtype=out_dt, device=x.device)

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vitcam_linear_int8(
            x.data_ptr(), _X_CODES[x.dtype], weight_q.data_ptr(), m, n, k,
            a_scale.data_ptr(), col_scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            ROUTES.index(route), EPILOGUES.index(epilogue),
            None if out_scales is None else out_scales.data_ptr(), groups,
            int(gelu_approx), out.data_ptr(),
            _OUT_CODES.get(out_dt, 2), INT8_GEMM_DESIGNS[design], stream)
    if err:
        raise RuntimeError(
            f"linear_int8 kernel launch failed ({design} design): "
            f"cudaError {err} "
            f"({lib.vitcam_cuda_error_string(err).decode()})")
    linear_int8_launches += 1
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# fused MLP: fc2(gelu(fc1(x))), the hidden tensor kept on chip
# ---------------------------------------------------------------------------

# The designs of the fused MLP kernels: "wgmma" (csrc/mlp_fused_wgmma.cu:
# 64-row blocks, a producer warp's TMA ring of weight tiles, wgmma, the fc2
# sums in registers), "mma" (csrc/mlp_fused.cu: 32-row blocks, mma.sync with
# cp.async double buffering, the fc2 sums in shared memory) and "fma" (the
# float32 kernel of csrc/mlp_fused.cu, FMAs on the CUDA cores).
MLP_DESIGNS = ("wgmma", "mma", "fma")
# The design bf16 / int8 calls run where the shape allows the wgmma design.
# Only chip_smoke.py sets "mma", to time the earlier design beside the new
# one; no config field or flag reaches them.
_mlp_bf16_design = "wgmma"
_mlp_int8_design = "wgmma"
# The shared memory one block may hold (sm_90's opt-in limit).  A block of
# every design owns its rows and one group of at most 768 output columns
# (wider C runs more groups, each computing fc1 again); what grows with C is
# the shared memory of the rows of x a block keeps whole, which sets each
# design's widest C (``MLP_MAX_C``).
MLP_SMEM_LIMIT = 232448
_MLP_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def mlp_smem_bytes(c: int, design: str, dtype) -> int:
    """Dynamic shared memory a block of the fused MLP kernel ``design`` takes
    at width ``c`` (dtype torch.int8 for ``mlp_fused_int8``), as the CUDA
    sources compute it (``vitcam_mlp_wgmma_smem_bytes``,
    ``vitcam_mlp_fused_smem_bytes``).

    "wgmma" (csrc/mlp_fused_wgmma.cuh): alignment slack, x [64, C] resident
    (bf16 by TMA; int8 quantized), two h tiles, and a ring of 24 KB stages
    with two mbarriers each, as many as fit up to 4 (bf16) or 6 (int8) and at
    least 2.  "mma" / "fma" (csrc/mlp_fused.cu): the [32, <= 768] float32 or
    int32 accumulator, the hidden chunk, the staging buffers, and for int8
    the quantized rows of x [32, C]."""
    kind = _MLP_KINDS[dtype]
    if design == "wgmma":
        esz, hspan, most = (1, 64, 6) if kind == 2 else (2, 128, 4)
        fixed = 1024 + -(-c * esz // 128) * 8192 + 2 * 64 * hspan + 8
        stage = 24576 + 16
        stages = min(most, max(2, (MLP_SMEM_LIMIT - fixed) // stage))
        return fixed + stages * stage
    acc = 4 * 32 * min(-(-c // 384), 2) * 384
    if kind == 2:
        return 32 * (-(-c // 64) * 64 + 16) + acc + 32 * 400 + 2 * 384 * 80
    if kind == 1:
        return acc + 2 * 32 * 392 + 2 * (32 + 384) * 40 * 2
    return acc + 4 * 32 * 388 + (32 * 36 + 32 * 388) * 4


def _widest_c(design, dtype):
    c = 64
    while mlp_smem_bytes(c + 64, design, dtype) <= MLP_SMEM_LIMIT:
        c += 64
    return c


# The widest C each design takes, where one is set: the wgmma design (x
# resident beside a ring of at least two stages) at bf16 and int8, the mma
# design's int8 kernel (the quantized rows of x beside the accumulator).  The
# float kernels of csrc/mlp_fused.cu take any C.
MLP_MAX_C = {("wgmma", torch.bfloat16): _widest_c("wgmma", torch.bfloat16),
             ("wgmma", torch.int8): _widest_c("wgmma", torch.int8),
             ("mma", torch.int8): _widest_c("mma", torch.int8)}


def mlp_design(c: int, hid: int, dtype) -> str:
    """The CUDA design a fused MLP call of width ``c``, hidden width
    ``hid`` and element type ``dtype`` runs: torch.bfloat16 or torch.float32
    for ``mlp_fused``, torch.int8 for ``mlp_fused_int8`` (whatever its x).

    The rule, and the only one: float32 runs "fma" (TF32 would change the
    numbers); bf16 and int8 run "wgmma" where C and HID are multiples of 64
    (the TMA boxes and wgmma tiles), else "mma".  ``_mlp_bf16_design`` /
    ``_mlp_int8_design`` = "mma" turn "wgmma" into "mma".  A width whose
    block would need more shared memory than ``MLP_SMEM_LIMIT`` in that
    design (past ``MLP_MAX_C``) has no kernel: it raises, naming the bytes.
    It picks by shape before the launch; a launch that fails raises and is
    never retried in another design."""
    if dtype == torch.float32:
        design = "fma"
    elif dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"mlp_design: bfloat16, float32 or int8, got {dtype}")
    elif c % 64 or hid % 64:
        design = "mma"
    else:
        design = _mlp_int8_design if dtype == torch.int8 \
            else _mlp_bf16_design
    need = mlp_smem_bytes(c, design, dtype)
    if need > MLP_SMEM_LIMIT:
        name = str(dtype).split(".")[-1]
        raise ValueError(
            f"the CUDA fused MLP kernel's {design} design at {name} takes C "
            f"<= {MLP_MAX_C[(design, dtype)]}: C={c} needs {need} bytes of "
            f"shared memory a block, past the {MLP_SMEM_LIMIT} one may hold; "
            "serve this width without mlp_fusion")
    return design


def _launch_error(lib, name, err, c, kind, design):
    """kind: 0 the float32 kernel, 1 the bfloat16 one, 2 the int8 one."""
    smem = (lib.vitcam_mlp_wgmma_smem_bytes if design == "wgmma"
            else lib.vitcam_mlp_fused_smem_bytes)(c, kind)
    return RuntimeError(
        f"{name} kernel launch failed ({design} design): cudaError {err} "
        f"({lib.vitcam_cuda_error_string(err).decode()}); shared memory "
        f"needed {smem} bytes")


def _check_mlp(x, w1, b1, w2, b2):
    if w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("w1 and w2 must be 2-D, [HID, C] and [C, HID]")
    hid, c = w1.shape
    if x.shape[-1] != c or tuple(w2.shape) != (c, hid):
        raise ValueError(f"x [..., {x.shape[-1]}], w1 {tuple(w1.shape)} and "
                         f"w2 {tuple(w2.shape)} do not chain as [.., C] x "
                         "[HID, C]^T x [C, HID]^T")
    for name, b, n in (("b1", b1, hid), ("b2", b2, c)):
        if b is not None and tuple(b.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(b.shape)}")
    return c, hid


def mlp_fused_plain(x, w1, b1, w2, b2, *, gelu_approx: bool = True):
    """Plain PyTorch version of the fused MLP.

    x [..., C]; w1 [HID, C], w2 [C, HID] in the torch layout [out, in] (the
    TPU kernel takes the transposes); b1 [HID], b2 [C].  The roundings of
    the TPU kernel: both products sum in at least float32, the bias and the
    GELU (jax.nn.gelu's formulas) are float32, the hidden tensor is rounded
    to x's type before fc2, b2 is added in float32, and the result is cast
    to x's type."""
    c, _ = _check_mlp(x, w1, b1, w2, b2)
    if b1 is None or b2 is None:
        raise ValueError("mlp_fused needs both biases")
    acc = torch.promote_types(x.dtype, torch.float32)
    h = torch.matmul(x.reshape(-1, c).to(acc), w1.to(acc).t()) + b1.to(acc)
    h = _gelu_f32(h, gelu_approx).to(x.dtype)
    out = torch.matmul(h.to(acc), w2.to(acc).t()) + b2.to(acc)
    return out.to(x.dtype).reshape(x.shape)


def mlp_fused(x, w1, b1, w2, b2, *, gelu_approx: bool = True):
    """Same contract as ``mlp_fused_plain``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel of ``mlp_design`` (x, weights
    and biases all float32 or all bfloat16, contiguous, C within the
    design's ``MLP_MAX_C``) or raise.  The kernel reads the weights in the torch layout: no
    transposed copy is made."""
    global mlp_fused_launches
    if x.device.type == "cpu":
        return mlp_fused_plain(x, w1, b1, w2, b2, gelu_approx=gelu_approx)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_fused: no kernel for device {x.device}")
    c, hid = _check_mlp(x, w1, b1, w2, b2)
    ops = (x, w1, b1, w2, b2)
    if b1 is None or b2 is None:
        raise ValueError("mlp_fused needs both biases")
    if x.dtype not in _OUT_CODES or any(t.dtype != x.dtype for t in ops):
        raise TypeError("mlp_fused takes x, weights and biases all float32 "
                        f"or all bfloat16, got {[t.dtype for t in ops]}")
    if any(t.device != x.device for t in ops):
        raise ValueError("mlp_fused: all operands must be on x's device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops):
        raise ValueError("mlp_fused: operands must be contiguous and "
                         "16-byte aligned")
    m = x.numel() // c
    if m == 0:
        raise ValueError("mlp_fused: empty x")
    design = mlp_design(c, hid, x.dtype)
    out = torch.empty_like(x)

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), m, c, hid)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if design == "wgmma":
            err = lib.vitcam_mlp_wgmma(*ptrs, int(gelu_approx), stream)
        else:
            err = lib.vitcam_mlp_fused(*ptrs, _OUT_CODES[x.dtype],
                                       int(gelu_approx), stream)
    if err:
        raise _launch_error(lib, "mlp_fused", err, c, _OUT_CODES[x.dtype],
                            design)
    mlp_fused_launches += 1
    return out


def _check_mlp_int8(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2):
    c, hid = _check_mlp(x, w1q, b1, w2q, b2)
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8:
        raise TypeError("w1q and w2q must be int8")
    if tuple(cs1.shape) != (hid,) or tuple(cs2.shape) != (c,):
        raise ValueError(f"cs1 must be [{hid}] and cs2 [{c}], got "
                         f"{tuple(cs1.shape)} and {tuple(cs2.shape)}")
    if inv_a1.numel() != 1 or inv_a2.numel() != 1:
        raise ValueError("inv_a1 and inv_a2 must be one-element tensors")
    return c, hid


def mlp_fused_int8_plain(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2, *,
                         gelu_approx: bool = True,
                         out_dtype=torch.bfloat16):
    """Plain PyTorch version of the fused int8 MLP: the chain of two
    fused-route int8 GEMMs, in the TPU kernel's op order.

    x [..., C] float; w1q int8 [HID, C], w2q int8 [C, HID] (torch layout);
    cs1 [HID], cs2 [C] the combined scales act_scale x weight_scale; b1, b2
    float32 or None; inv_a1, inv_a2 = 1 / act_scale of fc1 and fc2:

      xq = q(x * inv_a1);  h = gelu(acc1 * cs1 + b1);  hq = q(h * inv_a2)
      out = acc2 * cs2 + b2, cast to ``out_dtype``

    with exact int32 sums and q = clip(round(.), +-127).  The second GEMM
    takes hq as integer-valued float32 with a unit scale, which its
    prologue quantizes to itself."""
    _check_mlp_int8(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2)
    hq = linear_int8_ref(x, w1q, cs1, b1, inv_a1, route="fused",
                         epilogue="gelu", out_scales=inv_a2.reshape(1),
                         gelu_approx=gelu_approx)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    return linear_int8_ref(hq.to(torch.float32), w2q, cs2, b2, one,
                           route="fused", epilogue="float",
                           out_dtype=out_dtype)


def mlp_fused_int8(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2, *,
                   gelu_approx: bool = True, out_dtype=torch.bfloat16):
    """Same contract as ``mlp_fused_int8_plain``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel of ``mlp_design`` (x float32 or
    bfloat16; scales, biases and the inverse act scales float32; out float32
    or bfloat16; C within the design's ``MLP_MAX_C``) or raise."""
    global mlp_fused_int8_launches
    args = (x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2)
    if x.device.type == "cpu":
        return mlp_fused_int8_plain(*args, gelu_approx=gelu_approx,
                                    out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_fused_int8: no kernel for device {x.device}")
    c, hid = _check_mlp_int8(*args)
    given = [t for t in args if t is not None]
    vecs = [t for t in (cs1, b1, cs2, b2, inv_a1, inv_a2) if t is not None]
    if any(t.device != x.device for t in given):
        raise ValueError("mlp_fused_int8: all operands must be on x's device")
    if any(t.dtype != torch.float32 for t in vecs):
        raise TypeError("scales, biases and inverse act scales must be "
                        "float32")
    if x.dtype not in _OUT_CODES or out_dtype not in _OUT_CODES:
        raise TypeError(f"mlp_fused_int8 takes float32 or bfloat16 x and "
                        f"out_dtype, got {x.dtype} and {out_dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, w1q, w2q)) or \
            not all(t.is_contiguous() for t in vecs):
        raise ValueError("mlp_fused_int8: operands must be contiguous, x "
                         "and the weights 16-byte aligned")
    m = x.numel() // c
    if m == 0:
        raise ValueError("mlp_fused_int8: empty x")
    design = mlp_design(c, hid, torch.int8)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    fn = lib.vitcam_mlp_wgmma_int8 if design == "wgmma" \
        else lib.vitcam_mlp_fused_int8
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), _OUT_CODES[x.dtype], w1q.data_ptr(),
            cs1.data_ptr(), None if b1 is None else b1.data_ptr(),
            w2q.data_ptr(), cs2.data_ptr(),
            None if b2 is None else b2.data_ptr(), inv_a1.data_ptr(),
            inv_a2.data_ptr(), out.data_ptr(), _OUT_CODES[out_dtype], m, c,
            hid, int(gelu_approx), stream)
    if err:
        raise _launch_error(lib, "mlp_fused_int8", err, c, 2, design)
    mlp_fused_int8_launches += 1
    return out


# ---------------------------------------------------------------------------
# LayerNorm -> int8 quantize
# ---------------------------------------------------------------------------

def _check_ln(x, weight, bias):
    c = x.shape[-1]
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"LayerNorm weight and bias must be [{c}], got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")


def ln_quant_ref(x, weight, bias, *, eps: float, inv_a):
    """Plain PyTorch version: int8 = clip(round(layer_norm(x) * inv_a)),
    the LayerNorm with float32 two-pass statistics as the TPU kernel
    (mean, then the mean of squared deviations; rsqrt(var + eps); affine).
    x: [..., C] float; weight, bias: [C]; inv_a: 1 / act_scale of the
    consuming GEMM (a one-element float32 tensor)."""
    _check_ln(x, weight, bias)
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    d = x32 - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    y = y * weight.to(torch.float32) + bias.to(torch.float32)
    t = y * inv_a.reshape(()).to(torch.float32)
    return torch.clamp(torch.round(t), -127, 127).to(torch.int8)


_ln_quant_kernel = None


def _triton_ln_quant():
    """The Triton kernel, defined and compiled at first use (this module is
    imported where Triton is absent)."""
    global _ln_quant_kernel
    if _ln_quant_kernel is None:
        import triton
        import triton.language as tl
        from triton.language.extra import libdevice

        @triton.jit
        def ln_quant_kernel(x_ptr, w_ptr, b_ptr, inv_ptr, out_ptr, c, eps,
                            BLOCK: tl.constexpr):
            # one program per row: the row (C <= BLOCK) is read once, the
            # statistics are two float32 passes over registers
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            mask = cols < c
            x = tl.load(x_ptr + row * c + cols, mask=mask,
                        other=0.0).to(tl.float32)
            mean = tl.div_rn(tl.sum(x, axis=0), c.to(tl.float32))
            d = tl.where(mask, x - mean, 0.0)
            var = tl.div_rn(tl.sum(d * d, axis=0), c.to(tl.float32))
            rstd = tl.div_rn(1.0, tl.sqrt_rn(var + eps))
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = d * rstd * w + b
            t = y * tl.load(inv_ptr)
            q = tl.minimum(tl.maximum(libdevice.rint(t), -127.0), 127.0)
            tl.store(out_ptr + row * c + cols, q.to(tl.int8), mask=mask)

        _ln_quant_kernel = ln_quant_kernel
    return _ln_quant_kernel


def ln_quant(x, weight, bias, *, eps: float, inv_a):
    """Same contract as ``ln_quant_ref``.  CPU tensors run the plain
    version; CUDA tensors launch the Triton kernel (x float32 or bfloat16,
    contiguous, C <= 8192) or raise."""
    global ln_quant_launches
    if x.device.type == "cpu":
        return ln_quant_ref(x, weight, bias, eps=eps, inv_a=inv_a)
    if x.device.type != "cuda":
        raise ValueError(f"ln_quant: no kernel for device {x.device}")
    _check_ln(x, weight, bias)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ln_quant takes float32 or bfloat16 x, got {x.dtype}")
    if inv_a.numel() != 1 or inv_a.dtype != torch.float32:
        raise TypeError("inv_a must be a one-element float32 tensor")
    if any(t.device != x.device for t in (weight, bias, inv_a)):
        raise ValueError("ln_quant: all operands must be on x's device")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("x, weight and bias must be contiguous")
    c = x.shape[-1]
    block = max(16, 1 << (c - 1).bit_length())
    if block > 8192:
        raise ValueError(f"ln_quant: rows of C={c} exceed the kernel's 8192")
    rows = x.numel() // c
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if rows:
        kernel = _triton_ln_quant()
        with torch.cuda.device(x.device):
            kernel[(rows,)](x, weight, bias, inv_a, out, c, float(eps),
                            BLOCK=block, num_warps=4 if block <= 2048 else 8)
        ln_quant_launches += 1
    return out
