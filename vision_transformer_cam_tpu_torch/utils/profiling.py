"""Tracing and timing utilities (the port of
vision_transformer_cam_tpu/utils/profiling.py): a ``torch.profiler`` trace
context, a per-step wall-clock meter that waits for the card, CUDA-event
timers for kernels, the card's name and power limit, and the analytic FLOPs
model of every config in the zoo.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import torch

from vision_transformer_cam_tpu_torch.configs import ViTCAMConfig


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and the
    card's where there is one) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (chrome://tracing or Perfetto).  Yields the
    profiler, so the caller can read ``key_averages()`` afterwards."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(result):
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        for item in result:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


class StepTimer:
    """Wall-clock per-step meter.  ``stop(result)`` waits for the card when
    the result holds a CUDA tensor (``torch.cuda.synchronize``); a CPU result
    is complete when the call returns."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        leaf = _first_tensor(result)
        if leaf is not None and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)   # execution barrier
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)

    @property
    def best(self):
        return min(self.times) if self.times else float("nan")

    def images_per_sec(self, batch_size: int) -> float:
        return batch_size / self.best


def time_ms(fn, iters=20, warmup=3):
    """Mean ms of ``fn()`` over ``iters`` calls between two CUDA events, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kern, plain, iters=20):
    """(kernel ms, plain ms), each the mean of two ``time_ms`` runs, in turns
    (plain, kernel, kernel, plain)."""
    p1, k1 = time_ms(plain, iters), time_ms(kern, iters)
    k2, p2 = time_ms(kern, iters), time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def timeit(fn, *args, chunk=20, iters=3, device=None):
    """Best-of-``iters`` mean ms over ``chunk`` chained calls of ``fn(*args)``
    after two warm-up calls; every window is closed by one wait for the card
    (host clock; on the CPU the calls are complete when they return)."""
    cuda = torch.device(device).type == "cuda" if device is not None \
        else torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn(*args)
    fn(*args)
    sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn(*args)
        sync()
        best = min(best, (time.perf_counter() - t0) / chunk)
    return best * 1e3


def card_line(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; "cpu" for a CPU run."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def model_flops(cfg: ViTCAMConfig, batch: int = 1,
                with_cam: bool = True) -> dict:
    """Analytic forward FLOPs (MACs*2) of the full CAM model: patch embed,
    per-block qkv/logits/PV/proj/MLP, heads, and the CAM machinery (rollout
    joint chain) when with_cam."""
    n, d, hid = cfg.seq_len, cfg.embed_dim, cfg.mlp_hidden
    h, dh, L = cfg.num_heads, cfg.head_dim, cfg.depth
    patch = 2 * batch * cfg.num_patches * (cfg.patch_size ** 2 *
                                           cfg.in_chans) * d
    qkv = 2 * batch * n * d * 3 * d
    logits = 2 * batch * h * n * n * dh
    pv = 2 * batch * h * n * n * dh
    proj = 2 * batch * n * d * d
    mlp = 2 * 2 * batch * n * d * hid
    block = qkv + logits + pv + proj + mlp
    heads = 2 * batch * d * cfg.num_classes * 2
    cam = 2 * batch * n * n * n * L if with_cam else 0  # rollout joint chain
    total = patch + L * block + heads + cam
    return {"patch_embed": patch, "per_block": block, "blocks": L * block,
            "heads": heads, "rollout": cam, "total": total,
            "gflops_per_image": total / batch / 1e9,
            # the commonly quoted "17.6G" for ViT-B/16 is MACs (= FLOPs/2)
            "gmacs_per_image": total / batch / 2e9}
