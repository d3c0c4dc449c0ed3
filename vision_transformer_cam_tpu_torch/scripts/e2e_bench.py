"""End-to-end CAM export as ONE pipeline (the port of scripts/e2e_bench.py,
the BASELINE config #3 run).

The device-only benchmark (``bench``) excludes the host work the reference's
validate.py does per image: JPEG decode + resize / normalize, the device
forward, pseudo-seg, palette-PNG + CAM-overlay writes.  This script times all
of it through the REAL CLI (``cli.validate --serving int8 --ori_cam_path
...``) on a generated VOC-shaped tree, reporting the warm end-to-end img/s
that ``cli.validate`` measures (the first batch absorbs the kernel build and
the warm-up and is excluded).  The loop decodes and writes on the host, so
the number says what a user of the validate CLI gets per image, not what the
card can do.

  python -m vision_transformer_cam_tpu_torch.scripts.e2e_bench [--n 768]
      [--batch 64] [--serving int8] [--img 500x375] [--keep]
      [--native_decode] [--device cuda|cpu]

The card by default; ``--device cpu`` runs the same pipeline on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

NUM_CLASSES = 20


def build_tree(root: str, n: int, w: int, h: int, seed: int = 0) -> None:
    """VOC-shaped tree: JPEGImages/<id>.jpg (noise background + 1-2 colored
    squares), SegmentationClass/<id>.png (class-index masks), val.txt split
    (the reference's '/JPEGImages/<id>.jpg' lines whose [-15:-4] slice is
    the 11-char id), cls_labels.npy.  The draws and the files are those of
    the root scripts/e2e_bench.py, in its order."""
    import PIL.Image
    r = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "JPEGImages"))
    os.makedirs(os.path.join(root, "SegmentationClass"))
    colors = r.randint(0, 256, size=(NUM_CLASSES, 3))
    labels = {}
    lines = []
    for i in range(n):
        name = f"2010_{i:06d}"
        img = r.randint(90, 160, (h, w, 3)).astype(np.uint8)
        seg = np.zeros((h, w), np.uint8)
        lab = np.zeros(NUM_CLASSES, np.float32)
        for c in r.choice(NUM_CLASSES, size=r.randint(1, 3), replace=False):
            sq = r.randint(min(w, h) // 4, min(w, h) // 2)
            y0, x0 = r.randint(0, h - sq), r.randint(0, w - sq)
            img[y0:y0 + sq, x0:x0 + sq] = colors[c]
            seg[y0:y0 + sq, x0:x0 + sq] = c + 1
            lab[c] = 1.0
        PIL.Image.fromarray(img).save(
            os.path.join(root, "JPEGImages", name + ".jpg"), quality=85)
        PIL.Image.fromarray(seg).save(
            os.path.join(root, "SegmentationClass", name + ".png"))
        labels[name] = lab
        lines.append(f"/JPEGImages/{name}.jpg")
    np.save(os.path.join(root, "cls_labels.npy"), labels)
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> dict:
    """Build the tree, run the validate CLI over it, print one JSON line and
    return it."""
    from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                        resolve_device)
    argv = list(sys.argv if argv is None else ["e2e_bench.py"] + list(argv))
    check_cli_flags(argv, bool_flags=("--keep", "--native_decode"),
                    value_flags=("--n", "--batch", "--serving", "--img",
                                 "--device"),
                    prog="e2e_bench.py")

    def arg(flag, default):
        return argv[argv.index(flag) + 1] if flag in argv else default

    n = int(arg("--n", 768))
    batch = int(arg("--batch", 64))
    serving = arg("--serving", "int8")
    w, h = (int(v) for v in arg("--img", "500x375").split("x"))
    device = resolve_device(arg("--device", None))

    root = tempfile.mkdtemp(prefix="e2e_voc_")
    out = tempfile.mkdtemp(prefix="e2e_out_")
    try:
        t0 = time.time()
        build_tree(root, n, w, h)
        print(f"built {n}-image VOC tree in {time.time() - t0:.1f}s "
              f"({root})", flush=True)

        from vision_transformer_cam_tpu_torch.cli import validate
        vargv = ["--model_name", "vit_base_patch16_224_in21k",
                 "--dataset_path", root,
                 "--val_img_name_path", os.path.join(root, "val.txt"),
                 "--cls_labels_path", os.path.join(root, "cls_labels.npy"),
                 "--batch_size", str(batch),
                 "--serving", serving,
                 "--seg_pred_dir", os.path.join(out, "seg"),
                 "--ori_cam_path", os.path.join(out, "cam"),
                 "--device", str(device)]
        if "--native_decode" in argv:
            vargv.append("--native_decode")
        t0 = time.time()
        results = validate.main(vargv)
        wall = time.time() - t0
        n_png = len(os.listdir(os.path.join(out, "seg")))
        n_cam = len(os.listdir(os.path.join(out, "cam")))
        line = {
            "metric": "e2e_cam_export_img_per_s_warm",
            "value": results.get("img_per_s_end_to_end"),
            "unit": f"images/sec (decode->device->pseudo-seg->PNG, "
                    f"{device.type})",
            "wall_s_total": round(wall, 1),
            "img_per_s_incl_compile": round(n / wall, 2),
            "n_images": n, "serving": serving, "batch": batch,
            "seg_pngs": n_png, "cam_files": n_cam,
            "mAP": results.get("mAP"), "mIoU": results.get("mIoU"),
        }
        print(json.dumps(line), flush=True)
        return line
    finally:
        if "--keep" in argv:
            print(f"kept: tree {root}  outputs {out}")
        else:
            shutil.rmtree(root, ignore_errors=True)
            shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main()
