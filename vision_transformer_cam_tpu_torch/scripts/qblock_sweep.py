"""Sweep the attention kernel's q_block at a given shape on the card (the
port of the TPU package's scripts/qblock_sweep.py).

``q_block`` is the number of query rows a thread block of the fused attention
kernel owns, the rows of S (and of the head mean) it holds in shared memory:
16 or 32.  The taller tile re-reads K and V half as often; the shorter one
fits longer sequences and gives the card twice the blocks.  This probe times
ONE layer per candidate and prints ms/layer, or FAIL with the wrapper's
message where the tile does not fit a block's shared memory.

    python3 -m vision_transformer_cam_tpu_torch.scripts.qblock_sweep \
        [--batch 128] [--seq 577] [--heads 16] [--dh 64] [--bf16] [--f32] \
        [--block-b 1] [--post] [--no-clamp] [--bwd] [--device cuda] [qb ...]

Default dtype: int8 attention I/O.  --post probes the rollout_post-style call
(no joint; the kernel emits the float32 head-mean matrix instead), the long-N
serving default.  --f32 probes the training forward (float32 qkv, no joint,
no head mean).  --no-clamp matches the training softmax (row-max subtraction
in place of the serving clamp).  --bwd probes masked_attention_bwd at the
given dtype instead of the forward (it has no q_block).  --block-b is taken
for the TPU script's command lines and changes nothing: the card's grid is
one block per (query tile, image) already.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vision_transformer_cam_tpu_torch.kernels.attention import (
    Q_BLOCKS, masked_attention_bwd, masked_attention_fused)
from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                    resolve_device)
from vision_transformer_cam_tpu_torch.utils.profiling import timeit

_BOOL = ("--f32", "--bf16", "--post", "--no-clamp", "--bwd")
_VALUE = ("--batch", "--seq", "--heads", "--dh", "--block-b", "--device")


def _short(e: Exception) -> str:
    return type(e).__name__ + ": " + str(e)[:160].replace("\n", " ")


def main(argv=None, *, reps=10):
    """Prints one line per candidate and returns {candidate: ms or None}
    ({"bwd": ...} with --bwd)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_cli_flags(["qblock_sweep"] + argv, bool_flags=_BOOL,
                    value_flags=_VALUE, prog="qblock_sweep")

    def arg(flag, default):
        return int(argv[argv.index(flag) + 1]) if flag in argv else default

    dev = resolve_device(argv[argv.index("--device") + 1]
                         if "--device" in argv else None)
    b, n = arg("--batch", 128), arg("--seq", 577)
    h, dh = arg("--heads", 16), arg("--dh", 64)
    f32 = "--f32" in argv
    int8 = "--bf16" not in argv and not f32
    c = h * dh
    # positional candidates only: a digit token directly after a value flag
    # is that flag's value
    cands = [int(a) for i, a in enumerate(argv)
             if a.isdigit() and (i == 0 or argv[i - 1] not in _VALUE)] \
        or list(Q_BLOCKS)

    rng = np.random.default_rng(0)
    sc = None
    if int8:
        qkv = torch.from_numpy(rng.integers(-127, 128, (b, n, 3 * c))
                               .astype(np.int8))
        sc = torch.from_numpy(np.concatenate(
            [np.full(3 * h, 0.02), [1 / 0.05]]).astype(np.float32)).to(dev)
    else:
        qkv = torch.from_numpy(rng.standard_normal(
            (b, n, 3 * c), dtype=np.float32)).to(
                torch.float32 if f32 else torch.bfloat16)
    qkv = qkv.to(dev)
    bg = torch.zeros((b, n), dtype=torch.float32, device=dev)
    post, clamp = "--post" in argv, "--no-clamp" not in argv
    joint = None if post or f32 else torch.eye(
        n, dtype=torch.float32, device=dev).expand(b, n, n).contiguous()
    where = "" if dev.type == "cuda" else \
        "  [plain version on the CPU: not a device time]"

    def timed(fn):
        """ms per call over one window of ``reps`` calls, after warm-up."""
        with torch.inference_mode():
            return timeit(fn, chunk=reps, iters=1, device=dev)

    results = {}
    if "--bwd" in argv:
        name = str(qkv.dtype).split(".")[-1]
        try:
            if int8:
                raise TypeError("the backward takes float qkv: pass --bf16 "
                                "or --f32")
            do = torch.zeros((b, n, c), dtype=qkv.dtype, device=dev)
            ms = timed(lambda: masked_attention_bwd(
                qkv, bg, do, num_heads=h, scale=dh ** -0.5,
                clamp_softmax=clamp))
            print(f"bwd dtype={name}  {ms:7.2f} ms/layer{where}", flush=True)
            results["bwd"] = ms
        except (RuntimeError, ValueError, TypeError) as e:
            print(f"bwd dtype={name}  FAIL {_short(e)}", flush=True)
            results["bwd"] = None
        return results

    for qb in cands:
        try:
            ms = timed(lambda: masked_attention_fused(
                qkv, bg, joint, sc, num_heads=h, scale=dh ** -0.5,
                clamp_softmax=clamp, float_dtype=torch.bfloat16,
                with_headmean=post, hm_dtype=torch.float32 if post else None,
                q_block=qb))
            print(f"qb={qb:4d}  {ms:7.2f} ms/layer{where}", flush=True)
            results[qb] = ms
        except (RuntimeError, ValueError, TypeError) as e:
            # a tile that does not fit reports its bytes; keep sweeping
            print(f"qb={qb:4d}  FAIL {_short(e)}", flush=True)
            results[qb] = None
    return results


if __name__ == "__main__":
    main()
