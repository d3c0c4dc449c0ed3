"""Offline tools (the port of vision_transformer_cam_tpu/cli/tools.py): the
leaf scripts of the reference as subcommands, with the same subcommands and
flags.

  make_cls_labels    — build cls_labels.npy from the train(+val) split XML
                       annotations (the reference's voc12/make_cls_labels.py).
  make_splits        — the voc12 split txt files from a VOC2012 installation.
  make_class_indices — class_indices.json, the id -> name map.
  get_palette        — dump a palette.json, either extracted from a VOC
                       SegmentationClass PNG or from the built-in VOC
                       colormap (the reference's get_palette.py).
  flops              — analytic FLOP count of single- vs multi-head attention
                       (dim 512, 1024 tokens, batch 32 by default; the
                       reference's flops.py traces with fvcore instead).
  convert            — move a checkpoint between containers: whatever
                       io/weights.load_weights reads (.pth, .npz of either
                       package, a checkpoint of the port's trainer) to the
                       JAX package's .npz or a reference-format .pth.
  convert_sbd        — SBD benchmark_RELEASE .mat ground truth -> VOC-palette
                       PNGs (the SegmentationClassAug convention).

No subcommand computes on a device: they read and write files on the host.
"""

from __future__ import annotations

import argparse
import os


def cmd_make_cls_labels(args):
    from vision_transformer_cam_tpu_torch.data.voc12 import make_cls_labels
    d = make_cls_labels(args.train_list, args.val_list, args.voc12_root,
                        args.out)
    print(f"wrote {args.out} with {len(d)} entries")


def cmd_make_splits(args):
    """Generate the voc12 split txt files (the reference ships them as data
    assets) from a VOC2012 installation: one line per image,
    '/JPEGImages/<id>.jpg /SegmentationClass<Aug>/<id>.png'.  Sources:
    ImageSets/Segmentation/{train,val,trainval}.txt, plus the SBD aug ids —
    from --aug_list when given, else from an existing SegmentationClassAug
    directory.

    --aug_list reconstructs the reference's 10 582-image train_aug split
    without the SegmentationClassAug PNGs being converted yet: pass any id
    list — SBD's dataset/{train,val}.txt concatenated, a copy of the
    reference's train_aug.txt itself, or one id per line — and the ids are
    merged with VOC's own seg-train ids and written against
    /SegmentationClassAug/."""
    seg_sets = os.path.join(args.voc12_root, "ImageSets", "Segmentation")
    aug_dir = os.path.join(args.voc12_root, "SegmentationClassAug")
    os.makedirs(args.out_dir, exist_ok=True)

    def write_split(name, ids, seg_folder):
        path = os.path.join(args.out_dir, f"{name}.txt")
        with open(path, "w") as f:
            for i in ids:
                f.write(f"/JPEGImages/{i}.jpg /{seg_folder}/{i}.png\n")
        print(f"wrote {path} ({len(ids)} images)")

    def read_ids(fname, root=seg_sets):
        # accepts bare-id lines ("2007_000032"), SBD lines, and full
        # reference-style lines ("/JPEGImages/2007_000032.jpg /Seg.../..png")
        with open(os.path.join(root, fname) if root else fname) as f:
            ids = []
            for line in f:
                tok = line.strip().split()
                if not tok:
                    continue
                ids.append(os.path.splitext(os.path.basename(tok[0]))[0])
            return ids

    aug_ids = None
    if args.aug_list:
        # the reference's split = VOC seg-train ∪ SBD train ∪ SBD val
        # (the standard 10 582-image "train_aug" recipe); merging with
        # VOC train here means an SBD-only list still reproduces it
        aug_ids = sorted(set(read_ids(args.aug_list, root=None))
                         | set(read_ids("train.txt")))
    elif os.path.isdir(aug_dir):
        aug_ids = sorted(os.path.splitext(p)[0]
                         for p in os.listdir(aug_dir) if p.endswith(".png"))
    has_aug = aug_ids is not None

    write_split("train", read_ids("train.txt"),
                "SegmentationClassAug" if has_aug else "SegmentationClass")
    write_split("val", read_ids("val.txt"),
                "SegmentationClassAug" if has_aug else "SegmentationClass")
    if has_aug:
        write_split("train_aug", aug_ids, "SegmentationClassAug")
        trainaug_val = sorted(set(aug_ids) | set(read_ids("val.txt")))
        write_split("trainaug_val", trainaug_val, "SegmentationClassAug")


def cmd_make_class_indices(args):
    """Write class_indices.json — the id -> name map the reference's
    predict.py loads at startup."""
    import json
    from vision_transformer_cam_tpu_torch.data.voc12 import CAT_LIST
    with open(args.out, "w") as f:
        json.dump({str(i): n for i, n in enumerate(CAT_LIST)}, f, indent=2)
    print(f"wrote {args.out}")


def cmd_get_palette(args):
    from vision_transformer_cam_tpu_torch.data.palette import (
        palette_from_png, save_palette_json)
    pal = palette_from_png(args.png) if args.png else None
    save_palette_json(args.out, pal)
    print(f"wrote {args.out}")


def attention_flops(dim: int, num_heads: int, seq_len: int,
                    batch: int) -> dict:
    """Analytic FLOPs of the reference Attention module for one forward:
    qkv GEMM, QK^T, PV, proj GEMM.  Counts MACs*2; fvcore (the reference's
    flops.py) reports MACs — both are printed."""
    n, d = seq_len, dim
    qkv = 2 * batch * n * d * 3 * d
    logits = 2 * batch * num_heads * n * n * (d // num_heads)
    pv = 2 * batch * num_heads * n * n * (d // num_heads)
    proj = 2 * batch * n * d * d
    total = qkv + logits + pv + proj
    return {"qkv": qkv, "qk^T": logits, "pv": pv, "proj": proj,
            "total_flops": total, "total_macs_fvcore_style": total // 2}


def cmd_flops(args):
    for heads in (1, args.num_heads):
        r = attention_flops(args.dim, heads, args.seq_len, args.batch)
        kind = "Self(1-head)" if heads == 1 else f"Multi({heads}-head)"
        print(f"{kind} Attention dim={args.dim} tokens={args.seq_len} "
              f"bs={args.batch}: {r['total_flops']/1e9:.3f} GFLOPs "
              f"({r['total_macs_fvcore_style']/1e9:.3f} GMACs)")


def cmd_convert(args):
    """Checkpoint container conversion: any input ``io.weights.load_weights``
    reads to the JAX package's .npz (``io.weights.save_npz``), or to a
    reference-loadable torch .pth state dict (the float weights under the
    reference's names, which the port's modules use) — so a model fine-tuned
    here can be validated with the JAX package or the original PyTorch repo,
    and back.  The model is a container only: it is built and loaded on the
    host, and nothing is computed."""
    if not args.out.endswith((".npz", ".pth")):
        raise SystemExit(f"--out must end in .npz or .pth, got {args.out!r}")
    import torch

    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.io import weights as wio
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    cfg = configs.resolve_model(args.model_name)(
        num_classes=args.num_classes)
    cfg = cfg.replace(representation_size=None)
    model = ViTCAM(cfg, device="cpu")
    wio.load_weights(args.weights, model, del_keys=())
    if args.out.endswith(".npz"):
        wio.save_npz(args.out, model, cfg)
    else:
        torch.save({k: v.detach().clone() for k, v in
                    model.state_dict().items()}, args.out)
    print(f"wrote {args.out}")


def cmd_convert_sbd(args):
    """SBD benchmark_RELEASE .mat ground truth -> VOC-palette PNGs in
    SegmentationClassAug/ — the last manual link in reproducing the
    reference's train_aug split."""
    from vision_transformer_cam_tpu_torch.data.voc12 import convert_sbd
    ids = None
    if args.id_list:
        with open(args.id_list) as f:
            ids = sorted({os.path.splitext(os.path.basename(
                line.strip().split()[0]))[0] for line in f if line.strip()})
    out_dir = args.out_dir or os.path.join(args.voc12_root,
                                           "SegmentationClassAug")
    if not args.out_dir and not args.voc12_root:
        raise SystemExit("pass --out_dir or --voc12_root")
    n = convert_sbd(args.mat_dir, out_dir, ids)
    print(f"converted {n} SBD .mat files -> {out_dir}")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("make_cls_labels")
    m.add_argument("--train_list", required=True)
    m.add_argument("--val_list", required=True)
    m.add_argument("--voc12_root", required=True)
    m.add_argument("--out", default="cls_labels.npy")
    m.set_defaults(fn=cmd_make_cls_labels)

    s = sub.add_parser("make_splits")
    s.add_argument("--voc12_root", required=True)
    s.add_argument("--out_dir", default="./voc12")
    s.add_argument("--aug_list", default="",
                   help="external SBD/augmented id list (bare ids, SBD "
                        "dataset/*.txt, or reference train_aug.txt format); "
                        "merged with VOC seg-train to write train_aug.txt "
                        "without needing SegmentationClassAug on disk yet")
    s.set_defaults(fn=cmd_make_splits)

    ci = sub.add_parser("make_class_indices")
    ci.add_argument("--out", default="class_indices.json")
    ci.set_defaults(fn=cmd_make_class_indices)

    g = sub.add_parser("get_palette")
    g.add_argument("--png", default="",
                   help="VOC SegmentationClass PNG; empty = built-in map")
    g.add_argument("--out", default="palette.json")
    g.set_defaults(fn=cmd_get_palette)

    cv = sub.add_parser("convert")
    cv.add_argument("--weights", required=True,
                    help=".pth / .npz / a checkpoint of cli.train (an orbax "
                         "directory of the JAX trainer: convert it to .npz "
                         "with the JAX package's tools first)")
    cv.add_argument("--out", required=True, help="target .npz or .pth")
    cv.add_argument("--model_name", default="vit_base_patch16_224_in21k")
    cv.add_argument("--num_classes", type=int, default=20)
    cv.set_defaults(fn=cmd_convert)

    cs = sub.add_parser("convert_sbd")
    cs.add_argument("--mat_dir", required=True,
                    help="SBD benchmark_RELEASE/dataset/cls directory")
    cs.add_argument("--voc12_root", default="",
                    help="write PNGs to <root>/SegmentationClassAug/")
    cs.add_argument("--out_dir", default="",
                    help="explicit output directory (overrides --voc12_root)")
    cs.add_argument("--id_list", default="",
                    help="convert only these ids (SBD dataset/*.txt format "
                         "accepted); default: every .mat in --mat_dir")
    cs.set_defaults(fn=cmd_convert_sbd)

    f = sub.add_parser("flops")
    f.add_argument("--dim", type=int, default=512)
    f.add_argument("--num_heads", type=int, default=8)
    f.add_argument("--seq_len", type=int, default=1024)
    f.add_argument("--batch", type=int, default=32)
    f.set_defaults(fn=cmd_flops)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
