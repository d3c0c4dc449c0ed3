"""PASCAL VOC 2012 data layer.

The reference's voc12/data.py (split parsing with the [-15:-4] name slice,
XML and cls_labels.npy multi-hot label loading, image / seg-label path
resolution) plus voc12/make_cls_labels.py, feeding the batched host pipeline
of ``data.loader``.  The port's own copy of the JAX package's data/voc12.py
(numpy, and PIL imported inside the functions that decode).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

IMG_FOLDER_NAME = "JPEGImages"
SEG_LABEL_FOLDER_NAME = "SegmentationClass"
ANNOT_FOLDER_NAME = "Annotations"

# label order is part of the public contract.
CAT_LIST = ['aeroplane', 'bicycle', 'bird', 'boat',
            'bottle', 'bus', 'car', 'cat', 'chair',
            'cow', 'diningtable', 'dog', 'horse',
            'motorbike', 'person', 'pottedplant',
            'sheep', 'sofa', 'train',
            'tvmonitor']

CAT_NAME_TO_NUM = {name: i for i, name in enumerate(CAT_LIST)}

NUM_CLASSES = len(CAT_LIST)


def load_img_name_list(dataset_path: str) -> List[str]:
    """split lines are '/JPEGImages/<id>.jpg [...]'; the
    image id is the fixed-width [-15:-4] slice of the first column."""
    with open(dataset_path) as f:
        lines = f.read().splitlines()
    return [line.split(' ')[0][-15:-4] for line in lines if line]


def get_img_path(img_name: str, voc12_root: str) -> str:
    return os.path.join(voc12_root, IMG_FOLDER_NAME, img_name + '.jpg')


def get_seg_label_path(img_name: str, voc12_root: str) -> str:
    return os.path.join(voc12_root, SEG_LABEL_FOLDER_NAME, img_name + '.png')


def load_image_label_from_xml(img_name: str, voc12_root: str) -> np.ndarray:
    """20-dim multi-hot from the annotation XML."""
    from xml.dom import minidom
    path = os.path.join(voc12_root, ANNOT_FOLDER_NAME, img_name + '.xml')
    el_list = minidom.parse(path).getElementsByTagName('name')
    label = np.zeros((NUM_CLASSES,), np.float32)
    for el in el_list:
        cat = el.firstChild.data
        if cat in CAT_NAME_TO_NUM:
            label[CAT_NAME_TO_NUM[cat]] = 1.0
    return label


def load_image_label_list_from_xml(img_name_list: Sequence[str],
                                   voc12_root: str) -> List[np.ndarray]:
    return [load_image_label_from_xml(n, voc12_root) for n in img_name_list]


def load_cls_labels(npy_path: str) -> Dict[str, np.ndarray]:
    """Load the precomputed name -> (20,) float32 multi-hot dict
   ."""
    return np.load(npy_path, allow_pickle=True).item()


def load_image_label_list_from_npy(img_name_list: Sequence[str],
                                   npy_path: str) -> List[np.ndarray]:
    d = load_cls_labels(npy_path)
    return [d[n] for n in img_name_list]


def make_cls_labels(train_list_path: str, val_list_path: str, voc12_root: str,
                    out_path: str) -> Dict[str, np.ndarray]:
    """voc12/make_cls_labels.py: union of two splits -> XML labels -> npy dict."""
    names = load_img_name_list(train_list_path) + \
        load_img_name_list(val_list_path)
    names = list(dict.fromkeys(names))  # dedupe, preserve order
    d = {n: load_image_label_from_xml(n, voc12_root) for n in names}
    np.save(out_path, d)
    return d


def read_sbd_segmentation(mat_path: str) -> np.ndarray:
    """GTcls.Segmentation from one SBD benchmark_RELEASE .mat (MATLAB v5
    struct: GTcls.{Segmentation uint8 [H,W], Boundaries, CategoriesPresent})
    -> uint8 [H, W] VOC class ids.  The last manual step of reconstructing
    the reference's 10 582-image train_aug split (docs/training.md
    'Reconstructing the train_aug split')."""
    try:
        from scipy.io import loadmat
    except ImportError as e:  # pragma: no cover - scipy is in the base image
        raise RuntimeError(
            "SBD .mat conversion requires scipy (scipy.io.loadmat); "
            "install scipy or convert with any standard public script") from e
    m = loadmat(mat_path)
    if "GTcls" not in m:
        raise ValueError(f"{mat_path}: no GTcls struct — not an SBD "
                         "cls ground-truth file")
    seg = m["GTcls"]["Segmentation"][0, 0]
    return np.ascontiguousarray(seg, np.uint8)


def convert_sbd(mat_dir: str, out_dir: str, ids=None) -> int:
    """Convert SBD cls/*.mat ground truth to VOC-palette PNGs named
    <id>.png in out_dir (the SegmentationClassAug convention).  ids: only
    convert these (e.g. dataset/train.txt ∪ val.txt); default = every .mat
    in mat_dir.  Returns the number converted."""
    import os

    from vision_transformer_cam_tpu_torch.data.palette import save_indexed_png
    os.makedirs(out_dir, exist_ok=True)
    if ids is None:
        ids = sorted(os.path.splitext(f)[0] for f in os.listdir(mat_dir)
                     if f.endswith(".mat"))
    for name in ids:
        seg = read_sbd_segmentation(os.path.join(mat_dir, f"{name}.mat"))
        save_indexed_png(os.path.join(out_dir, f"{name}.png"), seg)
    return len(ids)


class VOC12Dataset:
    """Index-addressable VOC12 sample source.

    __getitem__ returns a dict with 'name', 'image' (normalized float32 HWC),
    'label' ((20,) multi-hot, if labels are available) and 'seg_label'
    ([H, W] int32, if seg_label_flag).
    """

    def __init__(self, img_name_list_path: str, voc12_root: str,
                 cls_labels_path: Optional[str] = None,
                 seg_label_flag: bool = False,
                 img_size: int = 224,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        self.img_name_list = load_img_name_list(img_name_list_path)
        self.voc12_root = voc12_root
        self.seg_label_flag = seg_label_flag
        self.img_size = img_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.label_list = None
        if cls_labels_path:
            self.label_list = load_image_label_list_from_npy(
                self.img_name_list, cls_labels_path)
        elif os.path.isdir(os.path.join(voc12_root, ANNOT_FOLDER_NAME)):
            # Divergence from the reference, which hardcodes a pregenerated
            # voc12/cls_labels.npy and crashes without it:
            # fall back to reading the multi-hot labels straight from the
            # annotation XMLs (the same source make_cls_labels caches), so
            # mAP works out of the box on a stock VOC tree.
            self.label_list = load_image_label_list_from_xml(
                self.img_name_list, voc12_root)

    def __len__(self):
        return len(self.img_name_list)

    def image_path(self, idx: int) -> str:
        """Image file path (for a batched decoder)."""
        return get_img_path(self.img_name_list[idx], self.voc12_root)

    def meta(self, idx: int) -> dict:
        """Everything __getitem__ returns except the decoded image."""
        name = self.img_name_list[idx]
        item = {"name": name}
        if self.label_list is not None:
            item["label"] = np.asarray(self.label_list[idx], np.float32)
        if self.seg_label_flag:
            import PIL.Image
            seg = PIL.Image.open(get_seg_label_path(name, self.voc12_root))
            item["seg_label"] = np.asarray(seg, dtype=np.int32)
        return item

    def __getitem__(self, idx: int):
        from vision_transformer_cam_tpu_torch.data.transforms import (
            load_and_preprocess)
        name = self.img_name_list[idx]
        img = load_and_preprocess(get_img_path(name, self.voc12_root),
                                  self.img_size, self.mean, self.std)
        item = {"name": name, "image": img}
        if self.label_list is not None:
            item["label"] = np.asarray(self.label_list[idx], np.float32)
        if self.seg_label_flag:
            import PIL.Image
            seg = PIL.Image.open(get_seg_label_path(name, self.voc12_root))
            item["seg_label"] = np.asarray(seg, dtype=np.int32)
        return item
