"""Stage-level microbenchmarks on the card (the port of the TPU package's
scripts/microbench.py).

Times individual pieces of the CAM-extraction hot path, one variant per run:

    python3 -m vision_transformer_cam_tpu_torch.scripts.microbench <variant> \
        [--batch 512] [--device cuda]

  attn               fused attention kernel, one layer
  attn-headmean      the same with the head-mean matrix
  attn-rollout       the same with the in-kernel rollout update
  attn-int8          int8 attention I/O
  attn-int8-rollout  int8 I/O + rollout
  attn-v1            the split-tensor kernel (q, k, v [B, H, N, dh])
  attn-v1-headmean   the same with the head-mean matrix
  gemms              the 4 per-block GEMMs, bf16 (cuBLAS)
  gemms-int8         the same through the int8 GEMM kernel, static scales
  mlp / mlp-int8     the fused MLP kernels
  qkv-int8           the fused-quantize int8 GEMM at the qkv shape
  gemms-fused-int8   the whole per-block GEMM set on the fused int8 route
  dots-bf16 / dots-int8 / dots-int8-dq
                     pure GEMM rate: pre-quantized inputs, no quantize pass
                     (torch._int_mm, the library's plain int8 product, outside
                     any kernel); -dq adds the dequant epilogue
  ln                 the 2 per-block LayerNorms
  io                 host JPEG -> tensor: the native C++ pipeline against PIL
  model              the full CAM forward (bench parity)

Shapes: ViT-B/16 @224, batch 512, bf16, the headline bench configuration.
On ``--device cpu`` the kernels' plain versions run and every line says that
it is no device time.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.nn.functional as F

from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                    resolve_device)
from vision_transformer_cam_tpu_torch.utils.profiling import timeit

N, C, H, HID = 197, 768, 12, 3072
SCALE = 0.125
DEPTH = 12

VARIANTS = ("attn", "attn-headmean", "attn-rollout", "attn-int8",
            "attn-int8-rollout", "attn-v1", "attn-v1-headmean", "gemms",
            "gemms-int8", "mlp", "mlp-int8", "qkv-int8", "gemms-fused-int8",
            "dots-bf16", "dots-int8", "dots-int8-dq", "ln", "io", "model")


def _randn(shape, seed, device, dtype=torch.bfloat16, gain=1.0):
    t = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return (t * gain).to(dtype).to(device)


def _randint8(shape, seed, device):
    return torch.randint(-127, 127, shape, dtype=torch.int8,
                         generator=torch.Generator().manual_seed(seed)
                         ).to(device)


def _bg(b, n, device, dtype=torch.float32):
    return (torch.rand((b, n), generator=torch.Generator().manual_seed(1))
            < 0.3).to(dtype).to(device)


def _eye(b, n, device):
    return torch.eye(n, dtype=torch.float32).expand(b, n, n).contiguous() \
        .to(device)


def _qlayer(w, act, device):
    """A static int8 layer (zero bias) from a float [out, in] weight."""
    from vision_transformer_cam_tpu_torch.ops.quant import QLinear
    return QLinear.from_float(w, torch.zeros(w.shape[0]),
                              torch.tensor(act)).to(device)


def _io_line():
    """Host JPEG -> tensor: the native C++ pipeline against the PIL one, on
    VOC-typical 500x375 JPEGs.  Host-side only; no card involved."""
    import tempfile

    import numpy as np
    import PIL.Image
    from vision_transformer_cam_tpu_torch.data.transforms import (
        load_and_preprocess)
    from vision_transformer_cam_tpu_torch.io import native_loader

    rng = np.random.default_rng(0)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    with tempfile.TemporaryDirectory() as tmpd:
        paths = []
        for i in range(64):
            arr = rng.integers(0, 256, size=(375, 500, 3), dtype=np.uint8)
            p = os.path.join(tmpd, f"{i}.jpg")
            PIL.Image.fromarray(arr).save(p, quality=90)
            paths.append(p)
        load_and_preprocess(paths[0], 224, mean, std)
        t0 = time.perf_counter()
        for p in paths:
            load_and_preprocess(p, 224, mean, std)
        t_pil = time.perf_counter() - t0
        native = "unavailable"
        if native_loader.available():
            # warm outside the timed window: the first call may build and
            # load the library
            native_loader.decode_batch(paths[:4], 224)
            t0 = time.perf_counter()
            native_loader.decode_batch(paths, 224)
            native = f"{len(paths) / (time.perf_counter() - t0):.0f} img/s"
    return (f"io: native {native}, PIL {len(paths) / t_pil:.0f} img/s "
            f"({os.cpu_count()} host cores)")


def main(argv=None, *, n=N, c=C, heads=H, hid=HID, chunk=20, iters=3):
    """Times one variant and prints its line; returns the line.  ``n``, ``c``,
    ``heads``, ``hid`` and the window sizes are arguments so that a test can
    run a small shape."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_cli_flags(["microbench"] + argv, bool_flags=(),
                    value_flags=("--batch", "--device"), prog="microbench")

    def value(flag, default):
        return argv[argv.index(flag) + 1] if flag in argv else default

    names = [a for i, a in enumerate(argv) if not a.startswith("--")
             and (i == 0 or argv[i - 1] not in ("--batch", "--device"))]
    variant = names[0] if names else "attn"
    if variant not in VARIANTS:
        raise SystemExit(f"unknown variant {variant}; one of {VARIANTS}")
    if variant == "io":
        line = _io_line()
        print(line, flush=True)
        return line
    dev = resolve_device(value("--device", None))
    b = int(value("--batch", 512))
    dt = torch.bfloat16
    where = "" if dev.type == "cuda" else \
        "  [plain versions on the CPU: not a device time]"
    scale = (c // heads) ** -0.5

    def t(fn, *args, **kw):
        kw.setdefault("chunk", chunk)
        with torch.inference_mode():
            return timeit(fn, *args, iters=iters, device=dev, **kw)

    def per_model(label, ms, unit="ms/layer-call"):
        return (f"{label}: {ms:.2f} {unit}  ({ms * DEPTH:.1f} ms per "
                f"12-layer model){where}")

    if variant in ("attn", "attn-rollout", "attn-headmean"):
        from vision_transformer_cam_tpu_torch.kernels.attention import (
            masked_attention_fused)
        qkv = _randn((b, n, 3 * c), 0, dev)
        bg = _bg(b, n, dev, dt)
        joint = _eye(b, n, dev) if variant == "attn-rollout" else None
        ms = t(lambda: masked_attention_fused(
            qkv, bg, joint, num_heads=heads, scale=scale,
            with_headmean=variant == "attn-headmean", clamp_softmax=True))
        line = per_model(variant, ms)

    elif variant in ("attn-int8", "attn-int8-rollout"):
        from vision_transformer_cam_tpu_torch.kernels.attention import (
            masked_attention_fused)
        qkv = _randint8((b, n, 3 * c), 0, dev)
        bg = _bg(b, n, dev)
        joint = _eye(b, n, dev) if variant.endswith("rollout") else None
        scales = torch.tensor([0.02, 0.02, 0.02, 1 / 0.05], device=dev)
        ms = t(lambda: masked_attention_fused(
            qkv, bg, joint, scales, num_heads=heads, scale=scale,
            clamp_softmax=True))
        line = per_model(variant, ms)

    elif variant in ("attn-v1", "attn-v1-headmean"):
        from vision_transformer_cam_tpu_torch.kernels.attention import (
            masked_attention)
        q, k, v = (_randn((b, heads, n, c // heads), s, dev)
                   for s in (0, 2, 3))
        bg = _bg(b, n, dev)
        ms = t(lambda: masked_attention(
            q, k, v, bg, scale=scale,
            with_headmean=variant == "attn-v1-headmean"))
        line = per_model(variant, ms)

    elif variant in ("gemms", "gemms-int8"):
        x = _randn((b, n, c), 0, dev)
        ws = [_randn(s, i + 1, "cpu", torch.float32, 0.02)
              for i, s in enumerate(((3 * c, c), (c, c), (hid, c), (c, hid)))]
        if variant == "gemms":
            wqkv, wproj, wfc1, wfc2 = (w.to(dt).to(dev) for w in ws)

            def f():
                q = F.linear(x, wqkv)
                o = F.linear(q[..., :c], wproj)
                h = F.gelu(F.linear(o, wfc1), approximate="tanh")
                return F.linear(h, wfc2)
        else:
            from vision_transformer_cam_tpu_torch.ops.quant import qlinear
            qqkv, qproj, qfc1, qfc2 = (_qlayer(w, 0.05, dev) for w in ws)

            def f():
                q = qlinear(x, qqkv, out_dtype=dt)
                o = qlinear(q[..., :c].contiguous(), qproj, out_dtype=dt)
                h = F.gelu(qlinear(o, qfc1, out_dtype=dt), approximate="tanh")
                return qlinear(h, qfc2, out_dtype=dt)
        line = per_model(variant, t(f), "ms/block GEMMs")

    elif variant in ("mlp", "mlp-int8", "qkv-int8", "gemms-fused-int8"):
        from vision_transformer_cam_tpu_torch.kernels.gemm import mlp_fused
        from vision_transformer_cam_tpu_torch.ops.quant import (
            linear_int8_fused, mlp_fused_int8)
        x = _randn((b, n, c), 0, dev)
        wfc1 = _randn((hid, c), 3, "cpu", torch.float32, 0.02)
        wfc2 = _randn((c, hid), 4, "cpu", torch.float32, 0.02)
        if variant == "mlp":
            w1, w2 = wfc1.to(dt).to(dev), wfc2.to(dt).to(dev)
            b1 = torch.zeros((hid,), dtype=dt, device=dev)
            b2 = torch.zeros((c,), dtype=dt, device=dev)
            ms = t(lambda: mlp_fused(x, w1, b1, w2, b2, gelu_approx=True))
            line = f"mlp(bf16 fused): {ms:.2f} ms ({ms * DEPTH:.1f} ms per " \
                   f"model){where}"
        elif variant == "mlp-int8":
            q1, q2 = _qlayer(wfc1, 0.05, dev), _qlayer(wfc2, 0.05, dev)
            ms = t(lambda: mlp_fused_int8(x, q1, q2, gelu_approx=True,
                                          out_dtype=dt))
            line = f"mlp-int8(fused): {ms:.2f} ms ({ms * DEPTH:.1f} ms per " \
                   f"model){where}"
        elif variant == "qkv-int8":
            qq = _qlayer(_randn((3 * c, c), 1, "cpu", torch.float32, 0.02),
                         0.05, dev)
            ms = t(lambda: linear_int8_fused(x, qq, out_dtype=dt))
            line = f"qkv-int8(fused): {ms:.2f} ms ({ms * DEPTH:.1f} ms per " \
                   f"model){where}"
        else:   # the whole per-block GEMM set
            qq = _qlayer(_randn((3 * c, c), 1, "cpu", torch.float32, 0.02),
                         0.05, dev)
            qp = _qlayer(_randn((c, c), 2, "cpu", torch.float32, 0.02), 0.05,
                         dev)
            q1, q2 = _qlayer(wfc1, 0.05, dev), _qlayer(wfc2, 0.05, dev)

            def f():
                q = linear_int8_fused(x, qq, out_dtype=dt)
                o = linear_int8_fused(q[..., :c].contiguous(), qp,
                                      out_dtype=dt)
                return mlp_fused_int8(o, q1, q2, gelu_approx=True,
                                      out_dtype=dt)
            ms = t(f)
            line = f"gemms-fused-int8: {ms:.2f} ms/block ({ms * DEPTH:.1f} " \
                   f"ms per model){where}"

    elif variant in ("dots-bf16", "dots-int8", "dots-int8-dq"):
        # pure GEMM rate isolation: pre-quantized inputs, no quantize pass;
        # -dq adds only the int32 -> scaled-bf16 dequant epilogue
        m = b * n
        shapes = [(c, 3 * c), (c, c), (c, hid), (hid, c)]
        if variant == "dots-bf16":
            ws = [_randn(s, i, dev, gain=0.02) for i, s in enumerate(shapes)]
            xs = [_randn((m, s[0]), 10 + i, dev)
                  for i, s in enumerate(shapes)]

            def f():
                return [torch.matmul(x, w) for x, w in zip(xs, ws)]
        else:
            ws = [_randint8(s, i, dev) for i, s in enumerate(shapes)]
            xs = [_randint8((m, s[0]), 10 + i, dev)
                  for i, s in enumerate(shapes)]
            dq = variant == "dots-int8-dq"

            def dot(x, w):
                if x.device.type == "cuda":
                    return torch._int_mm(x, w)
                return torch.matmul(x.to(torch.int32), w.to(torch.int32))

            def f():
                outs = []
                for x, w in zip(xs, ws):
                    acc = dot(x, w)
                    if dq:
                        acc = (acc.to(torch.float32) * 7.8e-5).to(dt)
                    outs.append(acc)
                return outs
        line = per_model(variant, t(f), "ms/block dots")

    elif variant == "ln":
        from vision_transformer_cam_tpu_torch.models.vit import _layer_norm
        x = _randn((b, n, c), 0, dev)
        sc = torch.ones((c,), dtype=dt, device=dev)
        bi = torch.zeros((c,), dtype=dt, device=dev)
        ms = t(lambda: _layer_norm(_layer_norm(x, sc, bi, 1e-6), sc, bi,
                                   1e-6))
        line = per_model("ln", ms, "ms per 2 LNs")

    else:   # model
        from vision_transformer_cam_tpu_torch import configs
        from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
        from vision_transformer_cam_tpu_torch.ops import rollout
        cfg = configs.resolve_model("vit_base_patch16_224_in21k")(
            num_classes=20)
        cfg = cfg.replace(representation_size=None, dtype=dt, param_dtype=dt,
                          attn_impl="kernel", gelu_approx=True,
                          softmax_clamp=True)
        model = ViTCAM(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
        images = _randn((b, cfg.img_size, cfg.img_size, 3), 1, dev,
                        torch.float32)

        def f():
            out = model(images, need_rollout=True)
            return rollout.cam_from_rollout_row(out.rollout_row,
                                                cfg.grid_size)
        ms = t(f, chunk=min(chunk, 10))
        line = f"model: {ms:.2f} ms/batch ({b / ms * 1e3:.0f} img/s){where}"

    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
