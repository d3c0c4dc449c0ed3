"""Host-side image preprocessing.

Matches the reference transform stack byte for byte: torchvision
Resize([224,224]) (PIL bilinear, antialiased) -> ToTensor -> Normalize with
ImageNet stats.  Output is NHWC float32, the layout of the model's inputs.
The port's own copy of the JAX package's data/transforms.py (numpy, and PIL
imported inside the functions that decode).
"""

from __future__ import annotations

import numpy as np


def pil_resize_bilinear(img, size: int):
    import PIL.Image
    return img.resize((size, size), PIL.Image.BILINEAR)


def normalize(arr_u8: np.ndarray, mean, std) -> np.ndarray:
    """uint8 HWC -> float32 HWC, /255 then (x - mean) / std."""
    x = arr_u8.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def load_and_preprocess(path: str, size: int, mean, std) -> np.ndarray:
    """JPEG decode -> RGB -> resize(size,size) bilinear -> normalize.
    Returns [size, size, 3] float32."""
    import PIL.Image
    img = PIL.Image.open(path).convert("RGB")
    img = pil_resize_bilinear(img, size)
    return normalize(np.asarray(img, np.uint8), mean, std)


def preprocess_array(img_u8: np.ndarray, size: int, mean, std) -> np.ndarray:
    """Same as load_and_preprocess but from an in-memory uint8 HWC array."""
    import PIL.Image
    img = PIL.Image.fromarray(img_u8).convert("RGB")
    img = pil_resize_bilinear(img, size)
    return normalize(np.asarray(img, np.uint8), mean, std)


def seg_resize_nearest(seg: np.ndarray, size: int) -> np.ndarray:
    """torchvision F.resize(seg, size, NEAREST) — shorter
    side scaled to `size`, aspect preserved, PIL NEAREST sampling."""
    import PIL.Image
    img = PIL.Image.fromarray(seg.astype(np.uint8))
    w, h = img.size
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    return np.asarray(img.resize((ow, oh), PIL.Image.NEAREST))
