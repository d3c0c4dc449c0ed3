"""VOC palette / colormap utilities (the port's own copy of the JAX
package's data/palette.py: numpy and PIL only).

Replaces get_palette.py (extract palette from a VOC PNG) and predict.py's
color_map generator (predict.py:31-48).  The VOC SegmentationClass PNG palette
IS the bit-interleaved colormap, so generating it and extracting it agree
bit-for-bit.
"""

from __future__ import annotations

import json
import os

import numpy as np


def color_map(n: int = 256, normalized: bool = False) -> np.ndarray:
    """predict.py:35-48: the PASCAL VOC bit-interleaved colormap."""
    dtype = "float32" if normalized else "uint8"
    cmap = np.zeros((n, 3), dtype=dtype)
    for i in range(n):
        c = i
        r = g = b = 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = np.array([r, g, b])
    return cmap / 255 if normalized else cmap


def voc_palette_flat() -> list:
    """Flat [r0,g0,b0, r1,g1,b1, ...] list of 768 ints — the structure the
    reference builds from palette.json (vit_model.py:203-210)."""
    return [int(v) for v in color_map().reshape(-1)]


def palette_from_png(png_path: str) -> list:
    """get_palette.py:6-15: read the palette out of an indexed PNG."""
    import PIL.Image
    img = PIL.Image.open(png_path)
    pal = img.getpalette()
    if pal is None:
        raise ValueError(f"{png_path} has no palette")
    return list(pal)


def save_palette_json(path: str, palette: list | None = None) -> None:
    """Write palette.json in the reference's format: a dict mapping the color
    index (as string) to its [r, g, b] triple (get_palette.py:9-15)."""
    palette = palette if palette is not None else voc_palette_flat()
    d = {str(i): [palette[3 * i], palette[3 * i + 1], palette[3 * i + 2]]
         for i in range(len(palette) // 3)}
    with open(path, "w") as f:
        json.dump(d, f)


def load_palette_json(path: str = "./palette.json") -> list:
    """validate.py:45-54 / vit_model.py:203-210: flatten palette.json values.
    Falls back to the generated VOC colormap when the file is absent (the
    reference hard-asserts instead)."""
    if not os.path.exists(path):
        return voc_palette_flat()
    with open(path, "rb") as f:
        d = json.load(f)
    flat = []
    for v in d.values():
        flat += v
    return flat


def save_indexed_png(path: str, labels: np.ndarray, palette: list | None = None
                     ) -> None:
    """Save a [H, W] uint8 label map as a palette PNG exactly like the
    reference's ToPILImage + putpalette + save (validate.py:258-262,278)."""
    import PIL.Image
    labels = np.asarray(labels)
    if labels.max(initial=0) > 255:
        # an indexed PNG holds <= 256 palette ids; a silent uint8 cast here
        # would WRAP large filler ids (compose_pseudo_seg keeps them int64
        # precisely so they fold correctly in scoring) into valid-looking
        # foreground classes on disk
        raise ValueError(
            f"save_indexed_png: label id {int(labels.max())} > 255 cannot "
            "be represented in an indexed PNG (num_classes too large for "
            "the palette-PNG contract)")
    img = PIL.Image.fromarray(labels.astype(np.uint8), mode="P")
    img.putpalette(palette if palette is not None else voc_palette_flat())
    img.save(path)


def save_indexed_png_batch(paths, labels, palette: list | None = None
                           ) -> None:
    """Batch form of save_indexed_png: the native threaded writer
    (native/vitcam_io.cc vitcam_write_png_batch) when available — decoded
    content (indices + palette) is identical to the PIL path, only the
    deflate byte stream differs — else a per-image PIL loop."""
    labels = [np.asarray(l) for l in labels]
    pal = palette if palette is not None else voc_palette_flat()
    if any(l.max(initial=0) > 255 for l in labels):
        # keep the single-image path's uint8-overflow contract
        for p, l in zip(paths, labels):
            save_indexed_png(p, l, pal)
        return
    from vision_transformer_cam_tpu_torch.io import native_loader
    if native_loader.artifacts_available():
        native_loader.write_png_batch(list(paths), labels, pal)
        return
    for p, l in zip(paths, labels):
        save_indexed_png(p, l, pal)
