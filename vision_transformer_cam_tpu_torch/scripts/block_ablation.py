"""Where the attention block kernel's time goes, on the card: its bf16
tensor-core design built with parts cut out, each build timed in turns with
the whole kernel and with its FMA design.

    python3 -m vision_transformer_cam_tpu_torch.scripts.block_ablation \
        [--batch 64] [--seq 197] [--iters 10]

Each variant is a copy of ``kernels/csrc/attention_block.cu`` (and the
headers it includes) in a temporary directory with one or more parts cut
out by a text edit: the qkv GEMM, the attention core, the rollout product,
the proj GEMM.  nvcc builds each copy into a library of its own (all at
once).  A part's time is the whole kernel's less that of the copy without
it.  The cut copies compute nothing meaningful; only their times are read.
The shape is ViT-B/16's (C = 768, 12 heads) with the rollout and the clamp,
as the bf16 fused serving path calls the kernel.  Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from vision_transformer_cam_tpu_torch.kernels import _build
from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                    resolve_device)
from vision_transformer_cam_tpu_torch.utils.profiling import (card_line,
                                                              time_ms)

_VALUE = ("--batch", "--seq", "--iters")
SOURCE = "attention_block.cu"
HEADERS = ("attention_common.cuh", "mma_common.cuh", "tile_gemm.cuh")
# In the tensor-core kernel: the text each cut replaces, and its stand-in
CUTS = {
    "qkv": ("      qkv_gemm(acc, xn_b, q0, n, wqkv, c, h, stage);\n"
            "      const QkvRows row_of{c, h};\n"
            "      // every block has read",
            "      for (int e = 0; e < 2 * kGTN; ++e) acc[e] = 0.01f * e;\n"
            "      __syncthreads();\n"
            "      const QkvRows row_of{c, h};\n"
            "      // every block has read"),
    "core": ("    unsigned qa[4][4];\n",
             "    if (h >= 0) {\n      cluster_arrive();\n      continue;\n"
             "    }\n    unsigned qa[4][4];\n"),
    "rollout": ("    rollout_rows<kQB, kGT, 4>(hm_s, hs, joint, newj, b, q0, "
                "n);\n", ""),
    "proj": ("  proj_out(attn_s, cs, wproj, bproj, tok, out, b, q0, n, c, "
             "stage);\n}\n\nstruct Args",
             "}\n\nstruct Args"),
}
VARIANTS = {"whole": (), "no qkv GEMM": ("qkv",), "no core": ("core",),
            "no rollout": ("rollout",), "no proj GEMM": ("proj",),
            "GEMMs only": ("core", "rollout"),
            "core only": ("qkv", "rollout", "proj")}


def cut_source(text: str, cuts) -> str:
    """``text`` (attention_block.cu) with the parts named in ``cuts`` cut
    out; each cut's text must occur exactly once."""
    for cut in cuts:
        old, new = CUTS[cut]
        if text.count(old) != 1:
            raise ValueError(f"block_ablation: the {cut!r} cut does not match "
                             f"{SOURCE} once; update CUTS to the source")
        text = text.replace(old, new)
    return text


def build_variants(workdir: Path) -> dict:
    """{variant: path of its library}, all built by parallel nvcc runs."""
    text = (_build.CSRC / SOURCE).read_text()
    for h in HEADERS:
        shutil.copy(_build.CSRC / h, workdir / h)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, libs = [], {}
    for i, (name, cuts) in enumerate(VARIANTS.items()):
        src, lib = workdir / f"v{i}.cu", workdir / f"v{i}.so"
        src.write_text(cut_source(text, cuts))
        procs.append(subprocess.Popen(
            [_build._nvcc(), *flags, "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs[name] = lib
    for name, p in zip(libs, procs):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
    return libs


def _operands(b, n, c, dev, seed=0):
    """bf16 xn, tokens ~ N(0, 1), weights ~ N(0, 1/C) in the torch layout,
    biases ~ 0.1 N(0, 1); 30 % background (cls never), a row-stochastic
    float32 joint."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, gain=1.0):
        return torch.from_numpy(
            (gain * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    ops = [t.to(torch.bfloat16).contiguous() for t in (
        rnd(b, n, c), rnd(b, n, c), rnd(3 * c, c, gain=c ** -0.5),
        rnd(3 * c, gain=0.1), rnd(c, c, gain=c ** -0.5), rnd(c, gain=0.1))]
    bg = torch.from_numpy((rng.random((b, n)) < 0.3).astype(np.float32))
    bg[:, 0] = 0.0
    joint = torch.softmax(rnd(b, n, n), dim=-1).contiguous()
    return ops, bg.to(dev), joint


def main(argv=None):
    """Prints one line per variant (and the FMA design) and the parts'
    times; returns {variant: ms}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_cli_flags(["block_ablation"] + argv, bool_flags=(),
                    value_flags=_VALUE, prog="block_ablation")

    def arg(flag, default):
        return int(argv[argv.index(flag) + 1]) if flag in argv else default

    dev = resolve_device()
    b, n, iters = arg("--batch", 64), arg("--seq", 197), arg("--iters", 10)
    heads, c = 12, 768
    ops, bg, joint = _operands(b, n, c, dev)
    out = torch.empty_like(ops[0])
    cls = torch.empty((b, n), dtype=torch.bfloat16, device=dev)
    newj = torch.empty_like(joint)
    with tempfile.TemporaryDirectory() as tmp:
        paths = build_variants(Path(tmp))
        fns = {}
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.vitcam_attention_block_fused.argtypes = \
                [p] * 11 + [i, i, i, i, f, f, i, i, i, i, p]
            for design in (1, 0) if name == "whole" else (1,):
                def call(lib=lib, design=design, name=name):
                    err = lib.vitcam_attention_block_fused(
                        *(t.data_ptr() for t in ops), bg.data_ptr(),
                        joint.data_ptr(), out.data_ptr(), cls.data_ptr(),
                        newj.data_ptr(), b, n, heads, 64, 0.125, -100.0, 1, 1,
                        -(-n // 32), design,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"block_ablation: {name!r} launch "
                                           f"failed, cudaError {err}")
                fns[name if design else "whole, FMA design"] = call
        # in turns: the order, then the order reversed
        got = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                got[name].append(time_ms(fns[name], iters))
    ms = {name: sum(v) / len(v) for name, v in got.items()}
    print(card_line(dev))
    for name, t in ms.items():
        print(f"block ablation bf16 rollout clamp B={b} N={n}: {name:18s} "
              f"{t:.4f} ms", flush=True)
    whole = ms["whole"]
    print("parts (whole less the copy without it): " + ", ".join(
        f"{part} {whole - ms[name]:.4f} ms" for part, name in (
            ("qkv GEMM", "no qkv GEMM"), ("core", "no core"),
            ("rollout", "no rollout"), ("proj GEMM", "no proj GEMM"))),
        flush=True)
    return ms


if __name__ == "__main__":
    main()
