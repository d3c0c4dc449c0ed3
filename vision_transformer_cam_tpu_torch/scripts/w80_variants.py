"""Kernel 1's tensor-core design at head width 80 under its two launch
bounds, on the card.

    python3 -m vision_transformer_cam_tpu_torch.scripts.w80_variants \
        [--batch 64] [--seq 257] [--iters 20]

At head width 80 a thread of the tensor-core design holds 40 float32
accumulators of O.  The kernel's bound of two blocks an SM caps it at 128
registers, and ptxas spills what does not fit; one block an SM lifts the
cap.  Each variant is a copy of ``kernels/csrc`` in a temporary directory,
the bound of the width-80 instances set by a text edit of
``masked_attention.cuh`` (the sources as they are for "two blocks an SM"),
built by nvcc into a library of its own, both at once.  For bf16 and
``int8_io`` qkv, the rollout variant with the clamp at ViT-H/14's shape (16
heads of 80), it prints each variant's blocks an SM, registers and local
memory a thread (``vitcam_masked_attention_occupancy``), whether the two
give identical bits, and their times in turns.  Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from vision_transformer_cam_tpu_torch.kernels import _build
from vision_transformer_cam_tpu_torch.kernels import attention as ka
from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                    resolve_device)
from vision_transformer_cam_tpu_torch.utils.profiling import (card_line,
                                                              time_ms)

_VALUE = ("--batch", "--seq", "--iters")
SOURCE = "masked_attention.cuh"
HEADS, DH = 16, 80
# the text each variant replaces in SOURCE, and its replacement
EDITS = {
    "two blocks an SM": None,
    "one block an SM": (
        "__launch_bounds__(kTcThreads, MT == 1 ? 2 : 1)",
        "__launch_bounds__(kTcThreads, MT == 1 && DH == 64 ? 2 : 1)"),
}


def edit_source(text: str, variant: str) -> str:
    """``text`` (masked_attention.cuh) as ``variant`` builds it; the edit's
    text must occur exactly once."""
    edit = EDITS[variant]
    if edit is None:
        return text
    old, new = edit
    if text.count(old) != 1:
        raise ValueError(f"w80_variants: the {variant!r} edit does not match "
                         f"{SOURCE} once; update EDITS to the source")
    return text.replace(old, new)


def build_variants(workdir: Path) -> dict:
    """{variant: path of its library} (kernel 1's two translation units),
    all built by parallel nvcc runs."""
    text = (_build.CSRC / SOURCE).read_text()
    procs, libs = [], {}
    for i, variant in enumerate(EDITS):
        src = workdir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        (src / SOURCE).write_text(edit_source(text, variant))
        lib = workdir / f"v{i}.so"
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "masked_attention.cu"),
             str(src / "masked_attention_w80.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs[variant] = lib
    for variant, p in zip(libs, procs):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {variant!r}:\n{log}")
    return libs


def _load(path):
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vitcam_masked_attention_fused.argtypes = \
        [p] * 8 + [i, i, i, i, i, f, f, i, i, i, i, i, i, p]
    lib.vitcam_masked_attention_occupancy.argtypes = \
        [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    return lib


def _operands(b, n, kind, dev):
    """qkv (bf16 ~ N(0, 1), or int8 with per-head scales and the output
    scale), 30 % background (cls never) and a row-stochastic joint."""
    g = torch.Generator(device=dev).manual_seed(5)
    c = HEADS * DH
    bg = (torch.rand((b, n), generator=g, device=dev) < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device=dev),
                          dim=-1)
    if kind == "int8_io":
        qkv = torch.randint(-127, 128, (b, n, 3 * c), generator=g, device=dev,
                            dtype=torch.int8)
        sc = 0.01 + 0.02 * torch.rand((3 * HEADS,), generator=g, device=dev)
        scales = torch.cat([sc, torch.tensor([20.0], device=dev)])
        return qkv, bg, joint, scales
    qkv = torch.randn((b, n, 3 * c), generator=g, device=dev)
    return qkv.to(torch.bfloat16).contiguous(), bg, joint, None


def main(argv=None):
    """Prints the card, each variant's occupancy and times, and whether the
    variants give identical bits; returns {(kind, variant): ms}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_cli_flags(["w80_variants"] + argv, bool_flags=(),
                    value_flags=_VALUE, prog="w80_variants")

    def arg(flag, default):
        return int(argv[argv.index(flag) + 1]) if flag in argv else default

    dev = resolve_device()
    b, n, iters = arg("--batch", 64), arg("--seq", 257), arg("--iters", 20)
    print(card_line(dev), flush=True)
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {v: _load(p) for v, p in build_variants(Path(tmp)).items()}
        for kind in ("bf16", "int8_io"):
            qkv, bg, joint, scales = _operands(b, n, kind, dev)
            int8 = kind == "int8_io"
            outs = {}
            for variant, lib in libs.items():
                info = (ctypes.c_int * 4)()
                err = lib.vitcam_masked_attention_occupancy(
                    n, ka._ROLLOUT, ka._DTYPE_CODES[qkv.dtype], 1, DH, info)
                if err:
                    raise RuntimeError(f"w80_variants: occupancy of "
                                       f"{variant!r}, cudaError {err}")
                print(f"w80 {kind} rollout N={n}, {variant}: {info[0]} "
                      f"blocks an SM, {info[1]} registers, {info[2]} bytes of "
                      f"local memory a thread, {info[3]} bytes of shared "
                      f"memory a block", flush=True)
                out = torch.empty((b, n, HEADS * DH), device=dev,
                                  dtype=torch.int8 if int8 else qkv.dtype)
                cls = torch.empty((b, n), device=dev, dtype=torch.bfloat16)
                newj = torch.empty_like(joint)

                def call(lib=lib, out=out, cls=cls, newj=newj,
                         variant=variant):
                    err = lib.vitcam_masked_attention_fused(
                        qkv.data_ptr(), bg.data_ptr(), joint.data_ptr(),
                        out.data_ptr(), cls.data_ptr(), None, newj.data_ptr(),
                        scales.data_ptr() if int8 else None,
                        ka._PER_HEAD if int8 else ka._NO_SCALES, b, n, HEADS,
                        DH, DH ** -0.5, -100.0, ka._DTYPE_CODES[qkv.dtype],
                        ka._ROLLOUT, 1,
                        (ka._OUT_I8 if int8 else 0) | ka._CLS_BF16, 0, 1,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"w80_variants: {variant!r} launch "
                                           f"failed, cudaError {err}")
                call()
                outs[variant] = (call, (out, cls, newj))
            torch.cuda.synchronize()
            first, second = (v[1] for v in outs.values())
            same = all(torch.equal(x, y) for x, y in zip(first, second))
            # in turns: the order, then the order reversed
            names = list(outs)
            times = {v: [] for v in names}
            for order in (names, names[::-1]):
                for v in order:
                    times[v].append(time_ms(outs[v][0], iters))
            for v in names:
                got[(kind, v)] = sum(times[v]) / len(times[v])
            print(f"w80 {kind} rollout B={b} N={n} H={HEADS} (identical bits "
                  f"{same}): " + ", ".join(
                      f"{v} {got[(kind, v)]:.4f} ms" for v in names),
                  flush=True)
    return got


if __name__ == "__main__":
    main()
