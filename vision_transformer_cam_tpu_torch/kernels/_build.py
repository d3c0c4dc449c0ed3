"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers), so
``nvcc`` compiles them in seconds, one process per source started together,
and links the objects into one shared library, loaded with ``ctypes``.  The
library is built at first use into
``<repo>/build/torch_kernels/<source hash>/`` and rebuilt when a source or the
flags change.  Nothing here runs at import time: this module is imported on
machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libvitcam_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the entry points of csrc/attn_variants.cu, vitcam_attn_variant_<name>
ATTN_VARIANT_ENTRIES = ("full", "noexp", "nomask", "matmul_only", "int8qk",
                        "int8pv", "int8both", "headbatch")

_lib = None
build_seconds = None   # wall time of the build this process ran, if any


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def lib_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless this source hash was built already: every
    ``.cu`` to an object in parallel, then one link.  The compilers' reports
    (``-Xptxas -v``) are kept beside it as ``build.log``."""
    global build_seconds
    so = lib_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmpdir:
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmpdir, s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        # link to a private name, then rename: a concurrent build never sees
        # a half-written library
        tmp = os.path.join(tmpdir, LIB_NAME)
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True) \
            if all(p.returncode == 0 for p in procs) else None
        log = "".join(f"== {s.name}\n{lg}" for s, lg in zip(srcs, logs))
        if res is not None:
            log += f"== link\n{res.stdout}{res.stderr}"
        (so.parent / "build.log").write_text(log)
        if res is None or res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def load():
    """The loaded library with every entry point's ctypes signature set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.vitcam_masked_attention_fused
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, f, i, i, i, i,
                       i, i, p]
        fn.restype = i
        fn = lib.vitcam_masked_attention_v1
        fn.argtypes = [p] * 7 + [i, i, i, i, f, f, i, i, i, p]
        fn.restype = i
        for variant in ATTN_VARIANT_ENTRIES:
            fn = getattr(lib, "vitcam_attn_variant_" + variant)
            fn.argtypes = [p] * 6 + [i, i, i, i, f, i, i, p]
            fn.restype = i
        fn = lib.vitcam_linear_int8
        fn.argtypes = [p, i, p, i, i, i, p, p, p, i, i, p, i, i, p, i, i, p]
        fn.restype = i
        fn = lib.vitcam_masked_attention_bwd
        fn.argtypes = [p, p, p, p, p, i, i, i, i, f, f, i, i, i, p]
        fn.restype = i
        fn = lib.vitcam_mlp_fused
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        fn = lib.vitcam_mlp_fused_int8
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        fn = lib.vitcam_mlp_wgmma
        fn.argtypes = [p] * 6 + [i, i, i, i, p]
        fn.restype = i
        fn = lib.vitcam_mlp_wgmma_int8
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        for name in ("vitcam_mlp_wgmma_occupancy", "vitcam_mlp_fused_occupancy"):
            fn = getattr(lib, name)
            fn.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
            fn.restype = i
        fn = lib.vitcam_attention_block_fused
        fn.argtypes = [p] * 11 + [i, i, i, i, f, f, i, i, i, i, p]
        fn.restype = i
        fn = lib.vitcam_attention_block_occupancy
        fn.argtypes = [i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
        fn = lib.vitcam_masked_attention_seq
        fn.argtypes = [p] * 7 + [i, i, i, i, i, i, f, f, i, i, i, i, i, p]
        fn.restype = i
        lib.vitcam_masked_attention_seq_smem_bytes.argtypes = [i, i, i]
        lib.vitcam_masked_attention_seq_smem_bytes.restype = ctypes.c_size_t
        lib.vitcam_mlp_fused_smem_bytes.argtypes = [i, i]
        lib.vitcam_mlp_fused_smem_bytes.restype = ctypes.c_size_t
        lib.vitcam_mlp_wgmma_smem_bytes.argtypes = [i, i]
        lib.vitcam_mlp_wgmma_smem_bytes.restype = ctypes.c_size_t
        lib.vitcam_attention_block_smem_bytes.argtypes = [i, i, i, i, i]
        lib.vitcam_attention_block_smem_bytes.restype = ctypes.c_size_t
        lib.vitcam_masked_attention_bwd_smem_bytes.argtypes = [i, i, i]
        lib.vitcam_masked_attention_bwd_smem_bytes.restype = ctypes.c_size_t
        fn = lib.vitcam_masked_attention_bwd_occupancy
        fn.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
        lib.vitcam_masked_attention_smem_bytes.argtypes = [i, i, i, i]
        lib.vitcam_masked_attention_smem_bytes.restype = ctypes.c_size_t
        fn = lib.vitcam_masked_attention_occupancy
        fn.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = i
        lib.vitcam_masked_attention_v1_smem_bytes.argtypes = [i, i, i]
        lib.vitcam_masked_attention_v1_smem_bytes.restype = ctypes.c_size_t
        lib.vitcam_attn_variant_smem_bytes.argtypes = [i, i, i, i]
        lib.vitcam_attn_variant_smem_bytes.restype = ctypes.c_size_t
        lib.vitcam_cuda_error_string.argtypes = [i]
        lib.vitcam_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
