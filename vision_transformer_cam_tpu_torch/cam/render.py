"""CAM heatmap rendering (utils.py:80-129); the port's own copy of the JAX
package's cam/render.py (numpy, PIL, cv2 when present).

Matches the reference's visual outputs: min-max uint8 normalization, JET
colormap, `heatmap*0.3 + img*0.5` blend, per-GT-class and synthesized-max
CAM jpgs.  Uses cv2 when present (exact parity with the reference's
COLORMAP_JET); a numpy JET fallback keeps the module importable without it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

try:
    import cv2
    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False


def cam_norm(cam: np.ndarray) -> np.ndarray:
    """utils.py:80-88: (cam - min) / max -> uint8 255."""
    cam = np.asarray(cam, dtype=np.float64)
    cam = cam - cam.min()
    # constant CAM (all-background image): reference divides 0/0 -> NaN
    return np.uint8(255 * cam / max(cam.max(), 1e-12))


def jet_colormap(u8: np.ndarray) -> np.ndarray:
    """COLORMAP_JET as BGR uint8 (cv2 layout).  Fallback implements the
    classic 4-segment jet ramp when cv2 is unavailable."""
    if _HAVE_CV2:
        return cv2.applyColorMap(u8, cv2.COLORMAP_JET)
    x = u8.astype(np.float64) / 255.0

    def ramp(v):
        return np.clip(1.5 - np.abs(v), 0.0, 1.0)

    r = ramp(4.0 * x - 3.0)
    g = ramp(4.0 * x - 2.0)
    b = ramp(4.0 * x - 1.0)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def _resize_u8(u8: np.ndarray, size_wh) -> np.ndarray:
    if _HAVE_CV2:
        return cv2.resize(u8, size_wh)
    from PIL import Image
    return np.asarray(Image.fromarray(u8).resize(size_wh, Image.BILINEAR))


def overlay_cam(cam: np.ndarray, img_bgr: np.ndarray) -> np.ndarray:
    """utils.py:111-114: resize normalized CAM to image size, JET, blend."""
    h, w = img_bgr.shape[:2]
    heat = jet_colormap(_resize_u8(cam_norm(cam), (w, h)))
    return (heat * 0.3 + img_bgr.astype(np.float64) * 0.5).astype(np.uint8)


def render_origin_cams(cams: np.ndarray, labels: np.ndarray,
                       names: Sequence[str], image_dir: str, out_dir: str,
                       *, images_bgr: Optional[Sequence[np.ndarray]] = None
                       ) -> None:
    """utils.py:91-129 (`generate_origin_cam`), without its hard-coded batch
    size 32 and absolute paths: per GT class overlay jpg + the max-over-GT
    synthesized CAM jpg per image.

    cams: [B, num_patches, num_classes] (the reference permutes
    [B, P, C] -> [B, C, 14, 14]); labels: [B, num_classes] multi-hot.
    """
    os.makedirs(out_dir, exist_ok=True)
    b, p, c = cams.shape
    g = int(round(p ** 0.5))
    grid = np.transpose(cams, (0, 2, 1)).reshape(b, c, g, g)
    for i in range(b):
        if images_bgr is not None:
            img = np.asarray(images_bgr[i])
        else:
            path = os.path.join(image_dir, names[i] + ".jpg")
            if _HAVE_CV2:
                img = cv2.imread(path)
                if img is None:  # cv2 returns None instead of raising
                    raise FileNotFoundError(
                        f"cv2 could not read image: {path}")
            else:
                from PIL import Image
                img = np.asarray(Image.open(path).convert("RGB"))[..., ::-1]
        cls_idx = np.flatnonzero(labels[i] > 0)
        per_cls = []
        for j in cls_idx:
            cam_ij = grid[i, j]
            per_cls.append(cam_ij)
            out = overlay_cam(cam_ij, img)
            # the reference reuses one filename per image (utils.py:115),
            # silently overwriting all but the last GT class — include the
            # class index so every per-class CAM survives
            _imwrite(os.path.join(out_dir,
                                  f"{names[i]}_cls{j}_siglabel_cam.jpg"),
                     out)
        if per_cls:
            syn = np.max(np.stack(per_cls), axis=0)
            _imwrite(os.path.join(out_dir, f"{names[i]}_syn_cam.jpg"),
                     overlay_cam(syn, img))


def _imwrite(path: str, img_bgr: np.ndarray) -> None:
    if _HAVE_CV2:
        cv2.imwrite(path, img_bgr)
    else:
        from PIL import Image
        Image.fromarray(img_bgr[..., ::-1]).save(path)


def jet_lut_rgb() -> np.ndarray:
    """The 256-entry JET colormap as an RGB uint8 LUT — cv2's exact
    COLORMAP_JET when cv2 is present, else the numpy ramp above.  This is
    what the native overlay renderer consumes, so native output uses the
    same colors as the Python path either way."""
    return jet_colormap(np.arange(256, dtype=np.uint8)
                        .reshape(256, 1))[:, 0, ::-1].copy()


def render_rollout_overlays(cams: np.ndarray, src_paths, dst_paths) -> None:
    """Batch rollout-CAM overlay export (the BASELINE-config-#3 artifact:
    utils.py:111-114 semantics per image at its source size).  Routes
    through the native threaded renderer (native/vitcam_io.cc
    vitcam_overlay_batch: libjpeg decode, PIL-semantics u8 resize of the
    normalized CAM, JET LUT, 0.3/0.5 double blend, libjpeg q95 encode)
    when available; composed RGB agrees with this module's math to ±2
    8-bit steps (resamplers differ in rounding — same class as the
    documented cv2-vs-PIL variance of the fallback).  Falls back to the
    per-image Python path otherwise."""
    cams = np.asarray(cams, np.float64)
    from vision_transformer_cam_tpu_torch.io import native_loader
    if native_loader.artifacts_available():
        native_loader.overlay_batch(list(src_paths), list(dst_paths), cams,
                                    jet_lut_rgb())
        return
    from PIL import Image
    for cam, src, dst in zip(cams, src_paths, dst_paths):
        img = np.asarray(Image.open(src).convert("RGB"))[..., ::-1]
        _imwrite(dst, overlay_cam(cam, img))
