"""ctypes bindings for the native IO library (native/vitcam_io.cc), the
port's own copy of the JAX package's io/native_loader.py.  The library is
host code outside both packages; where it cannot be built or loaded every
``*_available()`` answers false and the callers take their numpy / PIL
paths.

Builds the .so on first use (g++ + libjpeg, both in the base image), then
exposes `decode_batch(paths | buffers) -> [N, S, S, 3] float32` with
ImageNet normalization applied — the multi-threaded native replacement for
the reference's PIL-per-item DataLoader workers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libvitcam_io.so")

_lib = None
_unavailable = False   # a failed build or load is not tried again
_lib_lock = threading.Lock()


def _build() -> bool:
    try:
        # inter-PROCESS lock: on multi-host-on-one-box runs every process
        # reaches here concurrently, and two unsynchronized `make` runs
        # into the same .so can hand one process a partially written file;
        # flock + re-check makes the build happen exactly once.
        import fcntl
        os.makedirs(_NATIVE_DIR, exist_ok=True)
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            # run make unconditionally: its own dependency check makes this
            # a cheap no-op when up to date, and edits to native/ sources
            # rebuild instead of silently using a stale .so
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                           capture_output=True)
        return True
    except Exception as e:
        # surface the compiler/toolchain error once — a silent False here
        # made native-decode failures undiagnosable
        import sys
        detail = getattr(e, "stderr", b"") or b""
        print("native_loader: build failed "
              f"({e}){': ' + detail.decode(errors='replace').strip() if detail else ''}",
              file=sys.stderr)
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable.
    A process tries once: where the toolchain or libjpeg's headers are
    missing, every later call answers None at once instead of running the
    build again for each batch."""
    global _lib, _unavailable
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _unavailable:
            return None
        # ALWAYS run the (flock-guarded, no-op-when-fresh) build so edits
        # to native/ sources rebuild instead of silently loading a stale
        # .so; fall back to a pre-existing .so only if the build fails
        # (e.g. no toolchain on a deploy box).
        if not _build() and not os.path.exists(_SO_PATH):
            _unavailable = True
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _unavailable = True
            return None
        lib.vitcam_decode_batch.restype = ctypes.c_int
        lib.vitcam_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        if hasattr(lib, "vitcam_compose_batch"):
            dbl = ctypes.POINTER(ctypes.c_double)
            i32 = ctypes.POINTER(ctypes.c_int32)
            lib.vitcam_compose_one.restype = None
            lib.vitcam_compose_one.argtypes = [
                dbl, dbl, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_double, i32]
            lib.vitcam_compose_batch.restype = None
            lib.vitcam_compose_batch.argtypes = [
                dbl, dbl, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                i32, ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(i32), ctypes.c_int]
        if hasattr(lib, "vitcam_overlay_batch"):
            dbl = ctypes.POINTER(ctypes.c_double)
            u8 = ctypes.POINTER(ctypes.c_uint8)
            i32 = ctypes.POINTER(ctypes.c_int32)
            lib.vitcam_overlay_rgb_one.restype = ctypes.c_int
            lib.vitcam_overlay_rgb_one.argtypes = [
                u8, ctypes.c_long, dbl, ctypes.c_int, u8, u8, ctypes.c_int]
            lib.vitcam_overlay_batch.restype = ctypes.c_int
            lib.vitcam_overlay_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, dbl, ctypes.c_int, u8, ctypes.c_int,
                ctypes.c_int]
            lib.vitcam_write_png_batch.restype = ctypes.c_int
            lib.vitcam_write_png_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(u8),
                i32, ctypes.c_int, u8, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def decode_batch(items: Sequence, img_size: int = 224,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 num_threads: int = 0) -> np.ndarray:
    """items: file paths or raw JPEG bytes.  Returns [N, S, S, 3] float32."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    bufs = [open(it, "rb").read() if isinstance(it, (str, os.PathLike))
            else bytes(it) for it in items]
    n = len(bufs)
    arr_p = (ctypes.c_char_p * n)(*bufs)
    arr_l = (ctypes.c_long * n)(*[len(b) for b in bufs])
    mean_a = (ctypes.c_float * 3)(*mean)
    std_a = (ctypes.c_float * 3)(*std)
    out = np.empty((n, img_size, img_size, 3), np.float32)
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    fails = lib.vitcam_decode_batch(
        arr_p, arr_l, n, img_size, mean_a, std_a,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if fails:
        raise ValueError(f"{fails}/{n} JPEGs failed to decode")
    return out


def compose_available() -> bool:
    """The compose entry points postdate the decode ones — a stale prebuilt
    .so (no toolchain on a deploy box) may lack them."""
    lib = load_library()
    return lib is not None and hasattr(lib, "vitcam_compose_batch")


def artifacts_available() -> bool:
    """The overlay/PNG entry points postdate decode AND compose — gate on
    them separately so a stale .so degrades gracefully."""
    lib = load_library()
    return lib is not None and hasattr(lib, "vitcam_overlay_batch")


def overlay_batch(src_paths: Sequence[str], dst_paths: Sequence[str],
                  cams: np.ndarray, lut_rgb: np.ndarray,
                  quality: int = 95, num_threads: int = 0) -> None:
    """Render CAM-overlay JPEGs (reference utils.py:111-129 semantics:
    min-max-normalize the raw [g, g] CAM, resize to the source image size,
    JET LUT, heat*0.3 + img*0.5) for a batch of images, threaded in C.
    lut_rgb: [256, 3] uint8 colormap in RGB order (pass cv2's JET for exact
    reference colors — cam.render.jet_lut_rgb builds it)."""
    lib = load_library()
    if lib is None or not hasattr(lib, "vitcam_overlay_batch"):
        raise RuntimeError("native overlay unavailable")
    cams = np.ascontiguousarray(cams, np.float64)
    n, g, g2 = cams.shape
    assert g == g2, f"cams must be [N, g, g], got {cams.shape}"
    lut = np.ascontiguousarray(lut_rgb, np.uint8)
    assert lut.shape == (256, 3)
    src = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in src_paths])
    dst = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in dst_paths])
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fails = lib.vitcam_overlay_batch(
        src, dst, n, cams.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        g, lut.ctypes.data_as(u8p), quality, num_threads)
    if fails:
        raise ValueError(f"{fails}/{n} overlay renders failed")


def overlay_rgb_one(jpeg_bytes: bytes, cam: np.ndarray,
                    lut_rgb: np.ndarray) -> np.ndarray:
    """Test hook: the composed RGB buffer (pre-JPEG-encode contract)."""
    lib = load_library()
    if lib is None or not hasattr(lib, "vitcam_overlay_rgb_one"):
        raise RuntimeError("native overlay unavailable")
    cam = np.ascontiguousarray(cam, np.float64)
    g = cam.shape[0]
    lut = np.ascontiguousarray(lut_rgb, np.uint8)
    buf = np.frombuffer(jpeg_bytes, np.uint8)
    # decode once in Python just for the output size
    import PIL.Image
    import io as _io
    w, h = PIL.Image.open(_io.BytesIO(jpeg_bytes)).size
    out = np.empty((h, w, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    got = lib.vitcam_overlay_rgb_one(
        buf.ctypes.data_as(u8p), len(jpeg_bytes),
        cam.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), g,
        lut.ctypes.data_as(u8p), out.ctypes.data_as(u8p), out.nbytes)
    if got != out.nbytes:
        raise ValueError(f"native overlay failed (returned {got})")
    return out


def write_png_batch(paths: Sequence[str], labels: Sequence[np.ndarray],
                    palette_flat: Sequence[int], level: int = 1,
                    num_threads: int = 0) -> None:
    """Write [H, W] uint8 label maps as palette PNGs (decoded content
    identical to PIL putpalette/save; deflate level 1 — the artifact is the
    pixel data, not the byte stream), threaded in C."""
    lib = load_library()
    if lib is None or not hasattr(lib, "vitcam_write_png_batch"):
        raise RuntimeError("native PNG writer unavailable")
    n = len(paths)
    labs = [np.ascontiguousarray(l, np.uint8) for l in labels]
    pal = np.zeros(768, np.uint8)
    pf = np.asarray(list(palette_flat), np.uint8)
    pal[:pf.size] = pf
    sizes = np.ascontiguousarray(
        np.asarray([l.shape for l in labs], np.int32))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    path_arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lab_ptrs = (u8p * n)(*[l.ctypes.data_as(u8p) for l in labs])
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    fails = lib.vitcam_write_png_batch(
        path_arr, lab_ptrs,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        pal.ctypes.data_as(u8p), level, num_threads)
    if fails:
        raise ValueError(f"{fails}/{n} PNG writes failed")


def compose_batch(cos_maps: np.ndarray, bg_rows: np.ndarray,
                  patch_to_cls: np.ndarray, sizes, fg_thr: float,
                  bg_thr: float, num_threads: int = 0) -> list:
    """Native pseudo-seg compose (validate.py:177-257 host half), threaded
    across images.  cos_maps [N, K, g, g], bg_rows [N, g, g],
    patch_to_cls [N, K]; sizes: per-image (h, w).  Returns a list of
    [h_i, w_i] int32 class-id maps, bit-identical to
    cam.pseudo_seg.compose_pseudo_seg's numpy math (all-double, same lerp
    expression order)."""
    lib = load_library()
    if lib is None or not hasattr(lib, "vitcam_compose_batch"):
        raise RuntimeError("native compose unavailable")
    cm = np.ascontiguousarray(cos_maps, np.float64)
    bg = np.ascontiguousarray(bg_rows, np.float64)
    p2c = np.ascontiguousarray(patch_to_cls, np.int32)
    n, k, g, _ = cm.shape
    sz = np.ascontiguousarray(np.asarray(sizes, np.int32).reshape(n, 2))
    outs = [np.empty((int(h), int(w)), np.int32) for h, w in sz]
    i32p = ctypes.POINTER(ctypes.c_int32)
    out_ptrs = (i32p * n)(*[o.ctypes.data_as(i32p) for o in outs])
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    lib.vitcam_compose_batch(
        cm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        bg.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        p2c.ctypes.data_as(i32p), n, k, g,
        sz.ctypes.data_as(i32p), float(fg_thr), float(bg_thr),
        out_ptrs, num_threads)
    return outs
