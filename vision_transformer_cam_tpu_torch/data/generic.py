"""Generic path-list dataset (the port of
vision_transformer_cam_tpu/data/generic.py; the reference's my_dataset.py).

The reference's MyDataSet takes parallel lists of image paths and integer
class labels and is unused by the entry scripts; provided for API parity and
for non-VOC experiments.  Items are numpy, as the VOC dataset's: the loader
or the caller moves them to a device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from vision_transformer_cam_tpu_torch.data.transforms import (
    load_and_preprocess)


class PathListDataset:
    """__getitem__ -> {'name', 'image' (normalized float32 HWC), 'label'}.

    Unlike the reference (which raises on non-RGB images), any PIL-decodable
    image is converted to RGB.
    """

    def __init__(self, images_path: Sequence[str],
                 images_class: Optional[Sequence[int]] = None,
                 img_size: int = 224,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        self.images_path = list(images_path)
        self.images_class = list(images_class) if images_class is not None \
            else None
        self.img_size = img_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __len__(self):
        return len(self.images_path)

    def __getitem__(self, idx: int):
        path = self.images_path[idx]
        img = load_and_preprocess(path, self.img_size, self.mean, self.std)
        item = {"name": path, "image": img}
        if self.images_class is not None:
            item["label"] = np.int64(self.images_class[idx])
        return item


def collate_fn(items):
    """The reference's collate: stack images and labels."""
    out = {"name": [it["name"] for it in items],
           "image": np.stack([it["image"] for it in items])}
    if "label" in items[0]:
        out["label"] = np.asarray([it["label"] for it in items])
    return out
