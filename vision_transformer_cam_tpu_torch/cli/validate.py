"""Validation + pseudo-segmentation entry (the port of
vision_transformer_cam_tpu/cli/validate.py; the reference's validate.py).

The same capability surface: multi-label mAP from the top-16 patch head,
pseudo-seg PNG export with the VOC palette, 21-class mIoU against the
SegmentationClass ground truth, and the rollout-CAM overlays
(``--ori_cam_path``).  Batch size is honoured (the reference forces 1), the
palette needs no palette.json side file, and paths have no hard-coded
defaults.  ``--device`` is honoured: the card by default, the CPU on request.

``--seq_parallel N`` shards the token axis over N ranks of the process group
that the standard ``torch.distributed`` environment describes (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them);
without that environment the group is this one rank; rank 0 of each
sequence group writes its PNGs.  ``--data_parallel`` alone runs the
('data',) mesh over the ranks of that group, each rank a writer.

On either mesh ``--batch_size`` is the global batch: the world / N data
groups (N = 1 under ``--data_parallel``) each run their rows of every batch
of the one-rank run, the labels and head probabilities of each batch are
gathered over the data group for the mAP, and the writers' confusion
matrices are summed at the end, so the scores and the PNGs are those of a
one-rank run (with ``--batch_global_mask_norm`` too: the mask max is taken
over the data group, as JAX's over the batch sharded on 'data').
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

import numpy as np
import torch

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch import serving as _serving
from vision_transformer_cam_tpu_torch.cam.pseudo_seg import pseudo_seg_batch
from vision_transformer_cam_tpu_torch.data.loader import BatchLoader
from vision_transformer_cam_tpu_torch.data.palette import (
    load_palette_json, save_indexed_png_batch)
from vision_transformer_cam_tpu_torch.data.voc12 import VOC12Dataset
from vision_transformer_cam_tpu_torch.io import weights as wio
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.utils import resolve_device
from vision_transformer_cam_tpu_torch.utils.metrics import (ConfusionMatrix,
                                                            compute_mAP)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # reference flag surface (validate.py:296-314)
    p.add_argument("--model_name", type=str, default="vit_base",
                   help="'vit_base' (reference alias) or a MODEL_ZOO name")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--weights", type=str, default="",
                   help=".pth fine-tuned weights or a checkpoint of "
                        "cli.train; empty = random")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--dataset_path", type=str, required=True,
                   help="VOC2012 root (contains JPEGImages/)")
    p.add_argument("--val_img_name_path", type=str, required=True)
    p.add_argument("--ori_cam_path", type=str, default="",
                   help="when set, export attention-rollout CAM overlays "
                        "(one jpg per image) into this directory")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--cls_labels_path", type=str, default="")
    p.add_argument("--seg_pred_dir", type=str, default="./validate_seg_pred")
    p.add_argument("--palette_json", type=str, default="",
                   help="optional palette.json; default = built-in VOC map")
    p.add_argument("--limit", type=int, default=0,
                   help="stop after N images (smoke runs)")
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "eager", "kernel"],
                   help="auto = fused CUDA kernel on the card, eager on the "
                        "CPU")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard each batch over the ranks of the "
                        "torch.distributed process group (one rank per "
                        "card; --batch_size is the global batch)")
    p.add_argument("--seq_parallel", type=int, default=0, metavar="N",
                   help="shard the TOKEN axis over N ranks of the "
                        "torch.distributed process group (sequence "
                        "parallelism, cfg.seq_axis); the remaining world "
                        "size / N groups take stripes of the split.  For "
                        "long-N models (ViT-L@384).  The attention kernel "
                        "path is kept (each rank runs the kernel on its "
                        "token slice against the gathered keys and values); "
                        "the batch-axis kernel fusions and the int8 "
                        "attention I/O are switched off with a note.  The "
                        "ranks talk over NCCL when each has a card of its "
                        "own, else over gloo (CPU runs; ranks that share "
                        "one card, CUDA tensors staged through host memory)")
    p.add_argument("--batch_global_mask_norm", action="store_true",
                   help="couple the rollout mask normalization across the "
                        "eval batch (the reference's TRAINING semantics; "
                        "its validate runs batch 1 where the global max is "
                        "per-sample, which is our default)")
    p.add_argument("--native_decode", action="store_true",
                   help="use the C++ batched JPEG pipeline (threaded "
                        "decode+resize+normalize in one call; PIL "
                        "fallback when the .so is unavailable).  Pixels "
                        "match PIL within ~2 uint8 quanta; the default "
                        "PIL path is the exact reference-parity pipeline")
    p.add_argument("--serving", type=str, default="off",
                   choices=list(_serving.SERVING_MODES),
                   help="fast serving config (int8 modes calibrate on the "
                        "first images of the split): "
                        + _serving.serving_mode_help())
    return p


def val(args) -> dict:
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    device = resolve_device(args.device)
    os.makedirs(args.seg_pred_dir, exist_ok=True)
    palette = load_palette_json(args.palette_json) if args.palette_json \
        else None

    factory = configs.resolve_model(args.model_name)
    cfg = factory(num_classes=args.num_classes)
    cfg = cfg.replace(representation_size=None)  # has_logits=False
    impl = args.attn_impl
    if impl == "auto":
        impl = "kernel" if device.type == "cuda" else "eager"
    cfg = cfg.replace(attn_impl=impl)
    if not args.batch_global_mask_norm:
        # Reference-validate semantics: the reference's val DataLoader is
        # batch_size=1, so its global-max mask normalization is the
        # PER-SAMPLE max at inference; per sample also makes the results
        # independent of the batch's makeup.
        cfg = cfg.replace(per_sample_mask_norm=True)
    pcfg = configs.PseudoSegConfig()
    model = ViTCAM(cfg, device=device,
                   generator=torch.Generator().manual_seed(0))
    if args.weights:
        # full fine-tuned load, heads kept (validate.py:106-110)
        wio.load_weights(args.weights, model, del_keys=())

    mesh = None
    if args.seq_parallel:
        pmesh.distributed_init(device)
        mesh = pmesh.seq_parallel_mesh(args.seq_parallel)
        print(f"sequence parallelism: mesh {mesh.shape}, this rank at "
              f"(data {mesh.data_rank}, seq {mesh.seq_rank}); collectives: "
              f"{mesh.transport(device)}", flush=True)
    elif args.data_parallel:
        pmesh.distributed_init(device)
        mesh = pmesh.make_mesh((-1,), ("data",))
        print(f"data parallelism: {mesh.data_size} rank(s), this rank "
              f"{mesh.data_rank}; collectives: {mesh.transport(device)}",
              flush=True)
    n_groups = mesh.data_size if mesh else 1
    group_idx = mesh.data_rank if mesh else 0
    writer = mesh is None or mesh.seq_rank == 0
    if args.batch_size % n_groups:
        raise ValueError(f"--batch_size {args.batch_size} (the global batch) "
                         f"is not divisible by the {n_groups} data group(s)")

    ds = VOC12Dataset(args.val_img_name_path, args.dataset_path,
                      cls_labels_path=args.cls_labels_path or None,
                      seg_label_flag=True, img_size=cfg.img_size)
    # --native_decode is an explicit opt-in: the default PIL path IS the
    # reference-parity pixel pipeline the uint8-identical pseudo-seg claim
    # rests on; the C++ batched decode is pinned to it only within ~2 uint8
    # quanta, which can flip argmax ties in the exported PNGs.
    loader = BatchLoader(ds, args.batch_size // n_groups, shuffle=False,
                         drop_last=False, native_decode=args.native_decode,
                         process_index=group_idx, process_count=n_groups)

    if args.serving != "off":
        calib = None
        if args.serving.startswith("int8"):
            # calibrate through the SAME pixel pipeline that will serve
            calib_loader = BatchLoader(ds, min(8, len(ds)), shuffle=False,
                                       drop_last=False,
                                       native_decode=args.native_decode)
            calib = next(iter(calib_loader))["image"]
        _serving.apply_serving_mode(model, args.serving, calib_images=calib)
        # the mode's attention path resolves like --attn_impl auto; an
        # explicit --attn_impl wins
        model.cfg = model.cfg.replace(attn_impl=impl)
    if args.seq_parallel:
        model.cfg = pmesh.apply_seq_parallel(model.cfg)

    if args.ori_cam_path and writer:
        os.makedirs(args.ori_cam_path, exist_ok=True)
    loader_iter = loader
    if writer and group_idx == 0:
        try:
            from tqdm import tqdm
            loader_iter = tqdm(loader, file=sys.stdout)
        except ImportError:
            pass
    with pmesh.set_mesh(mesh):
        return _val_loop(args, loader_iter, model, pcfg, mesh, palette, ds,
                         writer)


def _val_loop(args, loader_iter, model, pcfg, mesh, palette, ds, writer):
    cfg = model.cfg
    device = next(model.parameters()).device
    confmat = ConfusionMatrix(args.num_classes)
    all_ap, n_done, t0 = [], 0, time.time()
    # warm end-to-end throughput: the first batch absorbs the kernel build
    # and the warm-up, so the decode -> device -> PNG rate starts after it
    t_warm, n_warm = None, 0
    for batch in loader_iter:
        images = torch.from_numpy(batch["image"]).to(device)
        out = model(images, need_rollout=bool(args.ori_cam_path))
        # duplicates that fill the last global batch are computed (every
        # group runs the same number of steps) but neither written nor scored
        keep = [i for i in range(len(batch["name"]))
                if not ("is_pad" in batch and batch["is_pad"][i])]
        names = [batch["name"][i] for i in keep]
        # the global batch's images, so that every rank stops at the same
        # batch under --limit
        n_done += len(names) if mesh is None else int(mesh.data_sum(
            torch.tensor(float(len(names)), device=device)))
        if writer and keep:
            _write_and_score(args, batch, keep, names, out, cfg, pcfg,
                             palette, confmat, all_ap if mesh is None
                             else None)
        if mesh is not None and "label" in batch:
            all_ap += _gathered_ap(mesh, batch, out)
        if t_warm is None:
            t_warm, n_warm = time.time(), n_done
        desc = (f"[val] {n_done}/{len(ds)} "
                f"mAP {np.mean(all_ap) if all_ap else float('nan'):.4f} "
                f"({(time.time() - t0) / max(n_done, 1):.3f}s/img)")
        if hasattr(loader_iter, "set_description"):
            loader_iter.set_description(desc)
        elif writer and (mesh is None or mesh.data_rank == 0):
            print(desc, flush=True)
        if args.limit and n_done >= args.limit:
            break

    if not writer:
        return {}
    if mesh is not None and mesh.data_size > 1:
        confmat = _summed_confmat(mesh, confmat)
    acc_global, acc, iou = confmat.compute()
    results = {
        "mAP": float(np.mean(all_ap)) if all_ap else float("nan"),
        "global_acc": float(acc_global),
        # nanmean: classes absent from both GT and prediction yield NaN IoU
        "mIoU": float(np.nanmean(np.asarray(iou)) * 100),
        "n_images": n_done,
    }
    if t_warm is not None and n_done > n_warm:
        results["img_per_s_end_to_end"] = round(
            (n_done - n_warm) / (time.time() - t_warm), 2)
    if mesh is None or mesh.data_rank == 0:
        if "img_per_s_end_to_end" in results:
            print(f"end-to-end (warm) throughput: "
                  f"{results['img_per_s_end_to_end']} img/s")
        print(confmat)
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        with open(f"validating_log_{stamp}.txt", "a") as f:
            f.write(f"[images: {n_done}]\n"
                    f"mAP_multiple_class_label: {results['mAP']:.5f}     \n\n")
    return results


def _write_and_score(args, batch, keep, names, out, cfg, pcfg, palette,
                     confmat, all_ap):
    """One batch's artifacts and scores, on the rank that writes."""
    from vision_transformer_cam_tpu_torch.data.voc12 import get_img_path
    if args.ori_cam_path:
        # rollout-CAM export with palette overlay (batched native renderer
        # when available, per-image Python path otherwise)
        from vision_transformer_cam_tpu_torch.cam.render import (
            render_rollout_overlays)
        from vision_transformer_cam_tpu_torch.ops.rollout import (
            cam_from_rollout_row)
        cams = cam_from_rollout_row(out.rollout_row, cfg.grid_size) \
            .float().cpu().numpy()[keep]
        render_rollout_overlays(
            cams, [get_img_path(n, args.dataset_path) for n in names],
            [os.path.join(args.ori_cam_path, f"{n}_rollout_cam.jpg")
             for n in names])
    segs = list(batch["seg_label"])
    preds = pseudo_seg_batch(out, cfg, pcfg, [s.shape for s in segs])
    probs = torch.sigmoid(out.head1_logits).float().cpu().numpy()
    save_indexed_png_batch(
        [os.path.join(args.seg_pred_dir, f"{n}.png") for n in names],
        [preds[i] for i in keep], palette)
    for i in keep:
        # Documented divergence: top-16 patches no feature maps to carry
        # the reference's arange filler 21+p (validate.py:146), which
        # overflows a 21-class confusion matrix.  Fold those no-evidence
        # patches to background before scoring; the exported PNG above
        # keeps the reference-exact filler values.
        scored = preds[i].reshape(-1).astype(np.int64)
        scored[scored > args.num_classes] = 0
        confmat.update(segs[i].reshape(-1), scored)
    if "label" in batch and all_ap is not None:
        all_ap += compute_mAP(batch["label"][keep], probs[keep])


def _gathered_ap(mesh, batch, out):
    """Per-sample APs of one global batch, in the one-rank order: the data
    ranks' labels, head probabilities and pad marks gathered (the same list
    on every rank)."""
    dev = out.head1_logits.device
    pad = np.asarray(batch.get("is_pad", np.zeros(len(batch["name"]), bool)))
    rows = [torch.from_numpy(np.asarray(batch["label"], np.float32)).to(dev),
            torch.sigmoid(out.head1_logits).float(),
            torch.from_numpy((~pad).astype(np.uint8)).to(dev)]
    labels, probs, keep = (mesh.data_all_gather(r).cpu().numpy()
                           for r in rows)
    keep = keep.astype(bool)
    return compute_mAP(labels[keep], probs[keep])


def _summed_confmat(mesh, confmat):
    """The writers' confusion matrices summed over the data group (the data
    group of sequence-rank 0 holds exactly the writers)."""
    import torch.distributed as dist
    parts = [None] * mesh.data_size
    dist.all_gather_object(parts, confmat.mat, group=mesh.data_group)
    merged = ConfusionMatrix(confmat.num_classes)
    mats = [m for m in parts if m is not None]
    if mats:
        merged.mat = sum(mats)
    return merged


def main(argv=None):
    args = build_parser().parse_args(argv)
    return val(args)


if __name__ == "__main__":
    main()
