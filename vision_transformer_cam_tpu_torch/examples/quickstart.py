"""End-to-end quickstart of the port on generated synthetic data — no VOC
download needed (the port of examples/quickstart.py).

Walks the full user path in one run, the way the reference repo is used
(train -> validate / pseudo-seg -> predict-CAM):

  1. generate a tiny synthetic VOC2012-shaped dataset (JPEGs of textured
     class-colored squares over noise + Annotations XMLs + seg-label PNGs);
  2. build the cls_labels.npy cache (``cli.tools make_cls_labels``);
  3. fine-tune a tiny ViT-CAM on it (``cli.train``, one device);
  4. batched validation: mAP + pseudo-segmentation PNGs + mIoU
     (``cli.validate``), once in parity mode and once through the int8
     serving tier;
  5. single-image CAM visualization grid (``cli.predict``);
  6. export the int8 serving artifact with a roundtrip check
     (``cli.export --check``) and serve the val images from it
     (``examples.serve_artifact``).

Run:  python -m vision_transformer_cam_tpu_torch.examples.quickstart
          [--workdir DIR] [--epochs N] [--device cuda|cpu]

On the card by default (the kernel paths: the attention kernel and its
backward in training, the attention and int8 GEMM kernels in the int8
validate, the export check and the served artifact); ``--device cpu`` runs
the same steps on the CPU.

The tiny model is the JAX quickstart's: img_size 64, patch 8, embed_dim 64,
depth 6, 4 heads of width 16, mask_from 2, top-4 patches.  On the card its
training runs kernel 1 and the attention backward at head width 16, and its
int8 validate, export check and served artifact kernel 1's int8 route.

For real VOC2012 training, swap step 1 for your dataset root and use the
full-size zoo models (run_train_and_validate_torch.sh).
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="./quickstart_out",
                   help="everything (dataset, weights, PNGs) goes here")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--n_train", type=int, default=16)
    p.add_argument("--n_val", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def make_synthetic_voc(root: str, names_train, names_val, img: int = 64):
    """A VOC2012-shaped tree whose images a tiny model can actually learn:
    each present class adds a textured colored square (the quality
    protocol's data, shrunk); seg-label PNGs are exact by construction.  The
    draws and the files are the JAX quickstart's, in its order."""
    import numpy as np
    import PIL.Image

    from vision_transformer_cam_tpu_torch.data import palette as pallib
    from vision_transformer_cam_tpu_torch.data.voc12 import CAT_LIST

    for d in ("JPEGImages", "SegmentationClass", "Annotations"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.RandomState(0)
    colors = rng.uniform(60, 255, size=(20, 3))
    freqs = rng.randint(3, 8, size=20)
    sq = img // 3
    yy, xx = np.mgrid[0:sq, 0:sq]
    for name in list(names_train) + list(names_val):
        arr = rng.normal(110, 18, size=(img, img, 3))
        seg = np.zeros((img, img), np.uint8)
        classes = rng.choice(20, size=rng.randint(1, 3), replace=False)
        for c in classes:
            y0, x0 = rng.randint(0, img - sq, size=2)
            tex = 0.7 + 0.3 * np.sin((xx + yy) * (np.pi / freqs[c]))
            arr[y0:y0 + sq, x0:x0 + sq] = colors[c] * tex[..., None]
            seg[y0:y0 + sq, x0:x0 + sq] = c + 1
        PIL.Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(
            os.path.join(root, "JPEGImages", f"{name}.jpg"), quality=95)
        pallib.save_indexed_png(
            os.path.join(root, "SegmentationClass", f"{name}.png"), seg)
        objs = "".join(f"<object><name>{CAT_LIST[c]}</name></object>"
                       for c in classes)
        with open(os.path.join(root, "Annotations", f"{name}.xml"),
                  "w") as f:
            f.write(f"<annotation>{objs}</annotation>")

    def write_split(path, names):
        with open(path, "w") as f:
            for n in names:
                f.write(f"/JPEGImages/{n}.jpg /SegmentationClass/{n}.png\n")

    write_split(os.path.join(root, "train.txt"), names_train)
    write_split(os.path.join(root, "val.txt"), names_val)


def tiny_demo(num_classes=20, has_logits=False, attn_impl="eager"):
    """The quickstart's zoo entry, the JAX quickstart's tiny ViT sized for the
    64x64 synthetic images.  ``attn_impl`` is the path the fine-tune takes
    (the train CLI, like the JAX one, trains on the config's; validate and
    predict resolve theirs from the device)."""
    from vision_transformer_cam_tpu_torch import configs
    return configs.ViTCAMConfig(img_size=64, patch_size=8, embed_dim=64,
                                depth=6, num_heads=4,
                                num_classes=num_classes, mask_from=2,
                                top_k_patches=4, attn_impl=attn_impl)


def main(argv=None):
    args = parse_args(argv)
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.cli import (export as ecli,
                                                      predict as pcli,
                                                      tools as tools_cli,
                                                      train as tcli,
                                                      validate as vcli)
    from vision_transformer_cam_tpu_torch.examples import serve_artifact
    from vision_transformer_cam_tpu_torch.utils import resolve_device
    dev = ["--device", str(resolve_device(args.device))]

    work = os.path.abspath(args.workdir)
    data = os.path.join(work, "VOCdevkit")
    os.makedirs(work, exist_ok=True)

    # a VOC-name-shaped id per image ([-15:-4] slice contract)
    names_train = [f"2007_{i:06d}" for i in range(args.n_train)]
    names_val = [f"2008_{i:06d}" for i in range(args.n_val)]

    print(f"[1/6] generating synthetic VOC tree under {data}")
    make_synthetic_voc(data, names_train, names_val)

    # on the card the fine-tune runs the attention kernel and its backward
    configs.MODEL_ZOO["tiny_demo"] = functools.partial(
        tiny_demo, attn_impl="kernel" if dev[1] == "cuda" else "eager")

    print("[2/6] building cls_labels.npy from the Annotations XMLs")
    labels_npy = os.path.join(work, "cls_labels.npy")
    tools_cli.main(["make_cls_labels",
                    "--train_list", os.path.join(data, "train.txt"),
                    "--val_list", os.path.join(data, "val.txt"),
                    "--voc12_root", data, "--out", labels_npy])

    bs = max(args.n_train // 4, 1)
    print(f"[3/6] fine-tuning tiny ViT-CAM for {args.epochs} epochs "
          f"(batch {bs}, on {dev[1]})")
    tcli.main(["--model_name", "tiny_demo",
               "--dataset_path", data,
               "--train_img_name_path", os.path.join(data, "train.txt"),
               "--val_img_name_path", os.path.join(data, "val.txt"),
               "--cls_labels_path", labels_npy,
               "--batch_size", str(bs),
               "--epochs", str(args.epochs), "--lr", "0.002",
               "--ckpt_dir", os.path.join(work, "weights"),
               "--log_dir", work] + dev)
    final = [f for f in os.listdir(os.path.join(work, "weights"))
             if "final" in f]
    ckpt = os.path.join(work, "weights", sorted(final)[-1])
    print(f"      checkpoint: {ckpt}")

    print("[4/6] validating: mAP + pseudo-seg PNGs + mIoU "
          "(parity mode, then the int8 serving tier)")
    common = ["--model_name", "tiny_demo", "--dataset_path", data,
              "--val_img_name_path", os.path.join(data, "val.txt"),
              "--cls_labels_path", labels_npy,  # use the cache from step 2
              "--weights", ckpt, "--batch_size", str(args.n_val)] + dev
    res = vcli.main(common + [
        "--seg_pred_dir", os.path.join(work, "seg_parity")])
    print(f"      parity:     mAP={res['mAP']:.3f} mIoU={res['mIoU']:.2f}")
    res8 = vcli.main(common + [
        "--serving", "int8",
        "--seg_pred_dir", os.path.join(work, "seg_int8")])
    print(f"      int8 serve: mAP={res8['mAP']:.3f} "
          f"mIoU={res8['mIoU']:.2f}")

    print("[5/6] single-image CAM grid (predict)")
    figure = []
    if importlib.util.find_spec("matplotlib") is None:
        # the grid is drawn with matplotlib, an optional dependency
        print("      matplotlib is not installed: the grid is not rendered "
              "(--no_figure); the CAM arrays are computed all the same")
        figure = ["--no_figure"]
    pcli.main(["--model_name", "tiny_demo", "--dataset_path", data,
               "--img_name", names_val[0], "--weights", ckpt,
               "--out", os.path.join(work, "predict_cam")] + dev + figure)

    print("[6/6] exporting the serving artifact + roundtrip check, then "
          "serving the val images from it")
    artifact = os.path.join(work, "tiny_demo_int8.pt2")
    ecli.main(["--model_name", "tiny_demo", "--weights", ckpt,
               "--serving", "int8", "--batch", str(args.n_val),
               "--calib_npy", "",  # toy model: random-calib warning is fine
               "--out", artifact, "--check"] + dev)
    serve_artifact.main(["--artifact", artifact,
                         "--images", os.path.join(data, "JPEGImages",
                                                  "2008_*.jpg"),
                         "--out", os.path.join(work, "served_cams")])

    print(f"\nDone. Everything is under {work}:")
    print("  seg_parity/ seg_int8/   pseudo-segmentation palette PNGs")
    print("  predict_cam/            the CAM visualization grid")
    print("  weights/                checkpoints of cli.train (validate / "
          "predict / export --weights accept them; cli.tools convert makes "
          "a .npz or .pth)")
    print(f"  {os.path.basename(artifact)}      deployable torch.export "
          "artifact (weights baked in)")
    print("  served_cams/            CAM overlays served from it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
